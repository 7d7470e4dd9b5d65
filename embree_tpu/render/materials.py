"""Material table + BSDF sampling (SoA, wavefront-friendly).

The reference pathtracer's material zoo
(tutorials/pathtracer/pathtracer_device.cpp:458-760): OBJ (diffuse +
phong specular + transparency, the loader's default), MATTE, MIRROR,
THIN_DIELECTRIC, EMITTER, METAL (Cook-Torrance with power-cosine
distribution and conductor fresnel, :601-626), REFLECTIVE_METAL
(delta mirror x conductor fresnel, :640-643), VELVET (horizon-scatter
lobe, :164-196), METALLIC_PAINT (dielectric-coated lambertian,
:741-760). All materials live in one SoA table; sampling/eval are
branch-free masked ops over the whole wavefront (the batched analog of the
reference's per-material virtual dispatch).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAT_MATTE = 0
MAT_OBJ = 1
MAT_MIRROR = 2
MAT_DIELECTRIC = 3        # THIN dielectric (ThinDielectricMaterial)
MAT_THIN_DIELECTRIC = 3
MAT_EMITTER = 4
MAT_METAL = 5             # microfacet conductor (power-cosine D)
MAT_REFLECTIVE_METAL = 6  # delta mirror x conductor fresnel
MAT_VELVET = 7            # horizon scattering (Velvety BRDF); f = ns
MAT_METALLIC_PAINT = 8    # dielectric-coated lambertian
MAT_DIELECTRIC_SOLID = 9  # full dielectric w/ interior Medium tracking
#                           (DielectricMaterial, pathtracer_device.cpp:683)
MAT_HAIR = 10             # AnisotropicBlinn Kr/Kt lobes (:761-776,:368-452)


class MaterialTable(NamedTuple):
    type: jnp.ndarray   # (M,) i32
    kd: jnp.ndarray     # (M, 3) diffuse / velvet horizonScatteringColor /
    #                     paint shadeColor / hair Kt
    ks: jnp.ndarray     # (M, 3) specular / mirror / metal reflectance /
    #                     velvet Minneart reflectance / hair Kr
    ns: jnp.ndarray     # (M,) phong exponent / velvet falloff / hair nx
    d: jnp.ndarray      # (M,) opacity (OBJ "d")
    eta: jnp.ndarray    # (M,) ior (dielectric INSIDE / paint) or
    #                     conductor eta
    k: jnp.ndarray      # (M,) conductor extinction (metal fresnel)
    rough: jnp.ndarray  # (M,) metal roughness (D exponent = 1/rough) /
    #                     velvet backScattering exponent / hair ny
    le: jnp.ndarray     # (M, 3) emission
    trans_in: jnp.ndarray   # (M, 3) dielectric interior transmission
    trans_out: jnp.ndarray  # (M, 3) dielectric exterior transmission
    eta_out: jnp.ndarray    # (M,) dielectric exterior ior


def make_material_table(mats: list[dict]) -> MaterialTable:
    n = max(len(mats), 1)
    t = np.zeros(n, np.int32)
    kd = np.full((n, 3), 0.5, np.float32)
    ks = np.zeros((n, 3), np.float32)
    ns = np.full(n, 10.0, np.float32)
    d = np.ones(n, np.float32)
    eta = np.full(n, 1.5, np.float32)
    kk = np.zeros(n, np.float32)
    rough = np.full(n, 0.1, np.float32)
    le = np.zeros((n, 3), np.float32)
    t_in = np.ones((n, 3), np.float32)
    t_out = np.ones((n, 3), np.float32)
    eta_out = np.ones(n, np.float32)
    for i, m in enumerate(mats):
        t[i] = m.get("type", MAT_OBJ)
        kd[i] = m.get("kd", (0.5, 0.5, 0.5))
        ks[i] = m.get("ks", (0.0, 0.0, 0.0))
        ns[i] = m.get("ns", 10.0)
        d[i] = m.get("d", 1.0)
        eta[i] = m.get("eta", 1.5)
        kk[i] = m.get("k", 0.0)
        rough[i] = m.get("roughness", 0.1)
        le[i] = m.get("le", (0.0, 0.0, 0.0))
        t_in[i] = m.get("transmission", (1.0, 1.0, 1.0))
        t_out[i] = m.get("transmission_outside", (1.0, 1.0, 1.0))
        eta_out[i] = m.get("eta_outside", 1.0)
    return MaterialTable(*map(jnp.asarray,
                              (t, kd, ks, ns, d, eta, kk, rough, le,
                               t_in, t_out, eta_out)))


def fresnel_conductor(cos_o, eta, k):
    """Unpolarized conductor Fresnel (average of Rs/Rp), scalar eta/k."""
    c = jnp.clip(jnp.abs(cos_o), 0.0, 1.0)
    e2k2 = eta * eta + k * k
    c2 = c * c
    rs = (e2k2 - 2.0 * eta * c + c2) / (e2k2 + 2.0 * eta * c + c2 + 1e-12)
    rp = (e2k2 * c2 - 2.0 * eta * c + 1.0) / (e2k2 * c2 + 2.0 * eta * c
                                              + 1.0 + 1e-12)
    return jnp.clip(0.5 * (rs + rp), 0.0, 1.0)


def fresnel_dielectric_schlick(cos_o, eta):
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    return r0 + (1.0 - r0) * (1.0 - jnp.abs(cos_o)) ** 5


def _ortho_basis(n):
    """Branchless ONB (Duff et al. / pixar)."""
    s = jnp.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = jnp.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    t2 = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t1, t2


def cosine_sample(n, u1, u2):
    """Cosine-weighted hemisphere around n; returns (dir, pdf)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * np.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    t1, t2 = _ortho_basis(n)
    d = x[..., None] * t1 + y[..., None] * t2 + z[..., None] * n
    pdf = jnp.maximum(z / np.pi, 1e-6)
    return d, pdf


def reflect(d, n):
    return d - 2.0 * jnp.sum(d * n, -1, keepdims=True) * n


def eval_brdf(mt: MaterialTable, mid, wo, ns_normal, wi,
              tan_x=None, tan_y=None, ng_geo=None):
    """f(wo, wi) * cos(wi) for NEE (diffuse + phong lobes)."""
    cos_i = jnp.maximum(jnp.sum(wi * ns_normal, -1), 0.0)
    kd = mt.kd[mid]
    diffuse = kd / np.pi * cos_i[..., None]
    # phong specular
    r = reflect(-wo, ns_normal)
    spec_cos = jnp.maximum(jnp.sum(wi * r, -1), 0.0)
    nsx = mt.ns[mid]
    phong = mt.ks[mid] * ((nsx + 2) / (2 * np.pi)
                          * spec_cos ** nsx * cos_i)[..., None]
    t = mt.type[mid]
    f = jnp.where((t == MAT_MATTE)[..., None], diffuse, 0.0)
    f = jnp.where((t == MAT_OBJ)[..., None], diffuse + phong, f)

    cos_o = jnp.maximum(jnp.sum(wo * ns_normal, -1), 0.0)
    # METAL: Cook-Torrance, power-cosine D, conductor F, V-cavity G
    # (MetalMaterial__eval, pathtracer_device.cpp:601-617)
    wh = wo + wi
    wh = wh / jnp.maximum(jnp.linalg.norm(wh, axis=-1, keepdims=True), 1e-12)
    cos_h = jnp.maximum(jnp.sum(wh * ns_normal, -1), 0.0)
    cos_ih = jnp.maximum(jnp.sum(wi * wh, -1), 1e-6)
    ex = 1.0 / jnp.maximum(mt.rough[mid], 1e-4)
    D = (ex + 2.0) / (2.0 * np.pi) * cos_h ** ex
    F = fresnel_conductor(cos_ih, mt.eta[mid], mt.k[mid])
    G = jnp.minimum(1.0, jnp.minimum(
        2.0 * cos_h * cos_o / cos_ih, 2.0 * cos_h * cos_i / cos_ih))
    metal = mt.ks[mid] * (F * D * G
                          / jnp.maximum(4.0 * cos_o, 1e-6)
                          * cos_i)[..., None]
    ok = (cos_i > 0) & (cos_o > 0)
    f = jnp.where((t == MAT_METAL)[..., None],
                  jnp.where(ok[..., None], metal, 0.0), f)

    # VELVET = Minneart(reflectance=ks, backScattering=rough)
    #        + Velvety(horizonScatteringColor=kd, falloff=ns)
    # (VelvetMaterial__eval, pathtracer_device.cpp:654-659)
    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o * cos_o, 0.0))
    velvety = mt.kd[mid] * (sin_o ** mt.ns[mid] * cos_i / np.pi)[..., None]
    back = jnp.clip(jnp.sum(wo * wi, -1), 0.0, 1.0) ** mt.rough[mid]
    minneart = mt.ks[mid] * (back * cos_i / np.pi)[..., None]
    f = jnp.where((t == MAT_VELVET)[..., None], velvety + minneart, f)

    # METALLIC_PAINT: dielectric-layered lambertian base (coat is delta)
    fo = fresnel_dielectric_schlick(cos_o, mt.eta[mid])
    fi = fresnel_dielectric_schlick(cos_i, mt.eta[mid])
    paint = mt.kd[mid] * (((1.0 - fo) * (1.0 - fi)) / np.pi
                          * cos_i)[..., None]
    f = jnp.where((t == MAT_METALLIC_PAINT)[..., None], paint, f)

    # HAIR: AnisotropicBlinn eval (:415-430) — Kr lobe when wi is on
    # the Ng side, Kt lobe otherwise, both through the anisotropic
    # power-cosine D over (Tx, Ty, Ng)
    if tan_x is None or tan_y is None:
        tan_x, tan_y = _ortho_basis(ns_normal)
    dz = ns_normal if ng_geo is None else ng_geo
    nx = mt.ns[mid]
    ny = mt.rough[mid]
    norm2 = jnp.sqrt((nx + 2) * (ny + 2)) / (2.0 * np.pi)
    cos_iz = jnp.sum(wi * dz, -1)
    wh_r = wo + wi
    wh_t = wo + (wi - 2.0 * cos_iz[..., None] * dz)   # reflect(wi, dz)
    whv = jnp.where((cos_iz > 0)[..., None], wh_r, wh_t)
    whv = whv / jnp.maximum(jnp.linalg.norm(whv, axis=-1, keepdims=True),
                            1e-12)
    cph = jnp.sum(whv * tan_x, -1)
    sph = jnp.sum(whv * tan_y, -1)
    cth = jnp.sum(whv * dz, -1)
    Rh = cph ** 2 + sph ** 2
    nh = jnp.where(Rh > 0, (nx * cph ** 2 + ny * sph ** 2)
                   / jnp.maximum(Rh, 1e-12), 0.0)
    d_h = jnp.where(Rh == 0, norm2, norm2 * jnp.abs(cth) ** nh)
    hair = jnp.where((cos_iz > 0)[..., None], mt.ks[mid], mt.kd[mid]) \
        * (d_h * jnp.abs(cos_iz))[..., None]
    f = jnp.where((t == MAT_HAIR)[..., None], hair, f)
    # mirror / dielectric(s) / reflective-metal are delta BSDFs -> no NEE
    return f


def fresnel_dielectric_exact(cos_i, cos_t, eta):
    """Exact unpolarized dielectric fresnel (optics.h:60-65); eta =
    from-side ior / to-side ior, both cosines positive."""
    rper = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-12)
    rpar = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-12)
    return jnp.clip(0.5 * (rpar * rpar + rper * rper), 0.0, 1.0)


def sample_bsdf(mt: MaterialTable, mid, wo, ns_normal, key):
    """Sample continuation direction; returns (wi, weight, is_delta).
    Vacuum-medium convenience wrapper over sample_bsdf_medium."""
    R = mid.shape
    wi, w, delta, _e, _t = sample_bsdf_medium(
        mt, mid, wo, ns_normal, key,
        jnp.ones(R, jnp.float32), jnp.ones(R + (3,), jnp.float32))
    return wi, w, delta


def sample_bsdf_medium(mt: MaterialTable, mid, wo, ns_normal, key,
                       med_eta, med_trans, tan_x=None, tan_y=None,
                       ng_geo=None):
    """Sample with Medium tracking (pathtracer_device.cpp:57-81):
    `med_eta`/`med_trans` is the per-ray medium the path currently
    travels in; MAT_DIELECTRIC_SOLID refraction pushes/pops it.
    Returns (wi, weight, is_delta, med_eta', med_trans'). `tan_x/tan_y`
    are the shading tangents for MAT_HAIR (AnisotropicBlinn axes);
    `ng_geo` the geometric normal (defaults to ns_normal)."""
    k1, k2, k3 = jax.random.split(key, 3)
    shape = mid.shape
    u1 = jax.random.uniform(k1, shape)
    u2 = jax.random.uniform(k2, shape)
    u3 = jax.random.uniform(k3, shape)

    t = mt.type[mid]
    kd = mt.kd[mid]
    ks = mt.ks[mid]

    # diffuse lobe
    wi_d, _pdf_d = cosine_sample(ns_normal, u1, u2)
    w_d = kd  # (kd/pi * cos) / (cos/pi)

    # mirror lobe
    wi_m = reflect(-wo, ns_normal)
    w_m = jnp.where(jnp.sum(ks, -1, keepdims=True) > 0, ks, kd)

    # dielectric: reflect or refract by fresnel (thin approximation:
    # refraction continues straight through, the reference's
    # ThinDielectric transmission)
    cos_o = jnp.clip(jnp.sum(wo * ns_normal, -1), -1.0, 1.0)
    eta = mt.eta[mid]
    r0 = ((1 - eta) / (1 + eta)) ** 2
    fres = r0 + (1 - r0) * (1 - jnp.abs(cos_o)) ** 5
    refl = u3 < fres
    wi_g = jnp.where(refl[..., None], wi_m, -wo)
    w_g = jnp.ones_like(kd)

    # OBJ: choose diffuse vs specular by energy
    pd = jnp.sum(kd, -1)
    psum = pd + jnp.sum(ks, -1)
    p_diff = jnp.where(psum > 0, pd / jnp.maximum(psum, 1e-6), 1.0)
    choose_d = u3 < p_diff
    # phong sample approximated by mirror lobe scaled (adequate for the
    # tutorial scenes; exact power-lobe sampling lands with the full
    # material zoo)
    wi_o = jnp.where(choose_d[..., None], wi_d, wi_m)
    w_o = jnp.where(choose_d[..., None],
                    kd / jnp.maximum(p_diff, 1e-6)[..., None],
                    ks / jnp.maximum(1 - p_diff, 1e-6)[..., None])

    cos_oo = jnp.maximum(jnp.sum(wo * ns_normal, -1), 0.0)

    # METAL: sample the power-cosine half-vector distribution around the
    # normal, reflect wo about it (MetalMaterial__sample :619-626);
    # weight = eval/pdf which reduces to reflectance * F * G-ratio —
    # approximated by reflectance * F (the D/pdf terms cancel)
    ex = 1.0 / jnp.maximum(mt.rough[mid], 1e-4)
    cos_h = u1 ** (1.0 / (ex + 2.0))
    sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 0.0))
    phi = 2.0 * np.pi * u2
    t1, t2 = _ortho_basis(ns_normal)
    wh = (sin_h * jnp.cos(phi))[..., None] * t1 \
        + (sin_h * jnp.sin(phi))[..., None] * t2 \
        + cos_h[..., None] * ns_normal
    wi_metal = reflect(-wo, wh)
    f_cond = fresnel_conductor(jnp.sum(wo * wh, -1), mt.eta[mid], mt.k[mid])
    # hemisphere rejection (MetalMaterial__sample :624-626): zero weight
    # when the sampled direction lands below the surface (or wo already
    # is) so continuation rays never start inside opaque geometry
    metal_up = (jnp.sum(wi_metal * ns_normal, -1) > 0.0) \
        & (jnp.sum(wo * ns_normal, -1) > 0.0)
    w_metal = jnp.where(metal_up[..., None], ks * f_cond[..., None], 0.0)

    # REFLECTIVE_METAL: delta mirror x conductor fresnel (:640-643)
    w_rmetal = ks * fresnel_conductor(cos_oo, mt.eta[mid],
                                      mt.k[mid])[..., None]

    # VELVET: cosine sample; weight = eval * pi / cos =
    # Velvety kd * sinO^f + Minneart ks * dot(wo,wi)^b
    # (VelvetMaterial__sample :661-669 via sample_component2)
    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_oo * cos_oo, 0.0))
    back_d = jnp.clip(jnp.sum(wo * wi_d, -1), 0.0, 1.0) ** mt.rough[mid]
    w_velvet = kd * (sin_o ** mt.ns[mid])[..., None] \
        + ks * back_d[..., None]

    # METALLIC_PAINT: coat (delta mirror) with prob F(cosO), else the
    # dielectric-layered lambertian base
    f_coat = fresnel_dielectric_schlick(cos_oo, mt.eta[mid])
    coat = u3 < f_coat
    wi_p = jnp.where(coat[..., None], wi_m, wi_d)
    w_p = jnp.where(coat[..., None], jnp.ones_like(kd),
                    kd * (1.0 - f_coat)[..., None])

    # DIELECTRIC_SOLID: reflect/refract with exact fresnel + Medium
    # push/pop (DielectricMaterial__sample :683-707). The medium we are
    # IN decides the eta ratio: front=current medium, back=the other.
    eta_in = mt.eta[mid]
    eta_ot = mt.eta_out[mid]
    ti_in = mt.trans_in[mid]
    ti_ot = mt.trans_out[mid]
    inside = (jnp.abs(med_eta - eta_in) < 1e-6) \
        & (jnp.max(jnp.abs(med_trans - ti_in), -1) < 1e-6)
    eta_r = jnp.where(inside, eta_in / jnp.maximum(eta_ot, 1e-6),
                      eta_ot / jnp.maximum(eta_in, 1e-6))
    cosO_d = jnp.clip(cos_o, 0.0, 1.0)
    kk_d = 1.0 - eta_r * eta_r * (1.0 - cosO_d * cosO_d)
    tir = kk_d < 0.0
    cosT = jnp.sqrt(jnp.maximum(kk_d, 0.0))
    # refract(wo, Ns, eta) (optics.h:47-54); pdf = eta^2
    wi_t = (eta_r[..., None] * (cosO_d[..., None] * ns_normal - wo)
            - cosT[..., None] * ns_normal)
    Rf = jnp.where(tir, 1.0,
                   fresnel_dielectric_exact(cosO_d, cosT, eta_r))
    # sample_component2 (:80-109): pick by max-component of c/pdf
    c_refl = Rf
    c_tran = (1.0 - Rf) / jnp.maximum(eta_r * eta_r, 1e-12)
    csum = c_refl + c_tran
    p_refl = jnp.where(csum > 0, c_refl / jnp.maximum(csum, 1e-12), 1.0)
    refl_d = (u3 < p_refl) | tir
    wi_ds = jnp.where(refl_d[..., None], wi_m, wi_t)
    # weight = c / (pdf * CP): reflect -> R/CP0; transmit ->
    # (1-R)/(eta^2 * CP1)
    w_ds_s = jnp.where(refl_d, Rf / jnp.maximum(p_refl, 1e-12),
                       (1.0 - Rf) / jnp.maximum(
                           eta_r * eta_r * (1.0 - p_refl), 1e-12))
    w_ds = jnp.where((csum > 0)[..., None],
                     jnp.broadcast_to(w_ds_s[..., None], kd.shape), 0.0)
    # medium after the event: reflect stays, transmit crosses
    die = t == MAT_DIELECTRIC_SOLID
    crossed = die & ~refl_d
    new_eta = jnp.where(crossed, jnp.where(inside, eta_ot, eta_in),
                        med_eta)
    new_trans = jnp.where(crossed[..., None],
                          jnp.where(inside[..., None], ti_ot, ti_in),
                          med_trans)

    # HAIR: AnisotropicBlinn (:368-452) over (Tx, Ty, Ng) with
    # Kr = ks (reflection), Kt = kd (transmission), (nx, ny) = (ns,
    # rough)
    if tan_x is None or tan_y is None:
        tan_x, tan_y = _ortho_basis(ns_normal)
    dz = ns_normal if ng_geo is None else ng_geo
    nx = mt.ns[mid]
    ny = mt.rough[mid]
    norm1 = jnp.sqrt((nx + 1) * (ny + 1)) / (2.0 * np.pi)
    norm2 = jnp.sqrt((nx + 2) * (ny + 2)) / (2.0 * np.pi)
    phi_h = 2.0 * np.pi * u1
    sin0 = jnp.sqrt(nx + 1) * jnp.sin(phi_h)
    cos0 = jnp.sqrt(ny + 1) * jnp.cos(phi_h)
    nrm_h = 1.0 / jnp.sqrt(jnp.maximum(sin0 ** 2 + cos0 ** 2, 1e-12))
    sinp = sin0 * nrm_h
    cosp = cos0 * nrm_h
    n_h = nx * cosp ** 2 + ny * sinp ** 2
    cos_th = u2 ** (1.0 / (n_h + 1.0))
    sin_th = jnp.sqrt(jnp.maximum(1.0 - cos_th ** 2, 0.0))
    pdf_h = norm1 * cos_th ** n_h
    wh_h = ((cosp * sin_th)[..., None] * tan_x
            + (sinp * sin_th)[..., None] * tan_y
            + cos_th[..., None] * dz)

    def _d_eval(whv):
        cph = jnp.sum(whv * tan_x, -1)
        sph = jnp.sum(whv * tan_y, -1)
        cth = jnp.sum(whv * dz, -1)
        Rh = cph ** 2 + sph ** 2
        nh = jnp.where(Rh > 0,
                       (nx * cph ** 2 + ny * sph ** 2)
                       / jnp.maximum(Rh, 1e-12), 0.0)
        return jnp.where(Rh == 0, norm2,
                         norm2 * jnp.abs(cth) ** nh)

    kr_max = jnp.max(ks, -1)
    kt_max = jnp.max(kd, -1)
    side = kr_max / jnp.maximum(kr_max + kt_max, 1e-12)
    h_refl = u3 < side
    wi_hr = reflect(-wo, wh_h)
    wi_ht = reflect(reflect(-wo, wh_h), dz)
    wi_h = jnp.where(h_refl[..., None], wi_hr, wi_ht)
    cos_ih = jnp.abs(jnp.sum(wi_h * dz, -1))
    d_wh = _d_eval(wh_h)
    pdf_hs = pdf_h * jnp.where(h_refl, side, 1.0 - side)
    c_h = jnp.where(h_refl[..., None], ks, kd) \
        * (d_wh * cos_ih)[..., None]
    w_h = c_h / jnp.maximum(pdf_hs, 1e-12)[..., None]

    wi = jnp.where((t == MAT_MIRROR)[..., None], wi_m, wi_d)
    w = jnp.where((t == MAT_MIRROR)[..., None], w_m, w_d)
    wi = jnp.where((t == MAT_OBJ)[..., None], wi_o, wi)
    w = jnp.where((t == MAT_OBJ)[..., None], w_o, w)
    wi = jnp.where((t == MAT_DIELECTRIC)[..., None], wi_g, wi)
    w = jnp.where((t == MAT_DIELECTRIC)[..., None], w_g, w)
    wi = jnp.where((t == MAT_METAL)[..., None], wi_metal, wi)
    w = jnp.where((t == MAT_METAL)[..., None], w_metal, w)
    wi = jnp.where((t == MAT_REFLECTIVE_METAL)[..., None], wi_m, wi)
    w = jnp.where((t == MAT_REFLECTIVE_METAL)[..., None], w_rmetal, w)
    wi = jnp.where((t == MAT_VELVET)[..., None], wi_d, wi)
    w = jnp.where((t == MAT_VELVET)[..., None], w_velvet, w)
    wi = jnp.where((t == MAT_METALLIC_PAINT)[..., None], wi_p, wi)
    w = jnp.where((t == MAT_METALLIC_PAINT)[..., None], w_p, w)
    wi = jnp.where(die[..., None], wi_ds, wi)
    w = jnp.where(die[..., None], w_ds, w)
    wi = jnp.where((t == MAT_HAIR)[..., None], wi_h, wi)
    w = jnp.where((t == MAT_HAIR)[..., None], w_h, w)
    is_delta = (t == MAT_MIRROR) | (t == MAT_DIELECTRIC) | die \
        | (t == MAT_REFLECTIVE_METAL) \
        | ((t == MAT_OBJ) & ~choose_d) \
        | ((t == MAT_METALLIC_PAINT) & coat)
    return wi, w, is_delta, new_eta, new_trans
