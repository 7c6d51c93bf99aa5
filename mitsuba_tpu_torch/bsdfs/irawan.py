"""Irawan & Marschner woven-cloth BRDF (port of mitsuba_tpu/bsdfs/irawan.py;
reference src/bsdfs/irawan.cpp:107-249 f(), :292-441 the filament and
staple integrands, :455-510 radiusOfCurvature, vonMises, seeliger; the
pattern and yarn data model of irawan.h:41-276).

Every cloth material's weave pattern and yarn segments live in small
padded tables shared by the wavefront (`pack_patterns`). Evaluation is
branchless: both integrands (the filament's for psi = 0, the staple's for
twisted yarns) and the four conic sections of the radius of curvature
are computed on every lane and selected. The reference's seeded
intensity variation and correlated umax noise are counter-based hashes
of the segment keys (`_hash01`, core/noise.py `perlin_noise`), in uint32
arithmetic held as int64 masked to 32 bits, so a lane's hashes are the
reference's bit for bit. Sampling is cosine-weighted, as the reference's
(irawan.cpp:245-263).

A lane needs the cloth tables, its pattern slot and its hit uv: the
material gather adds the first two (`_cloth`, `_cloth_slot`), the
dispatch the uv (`_uv`, bsdfs/dispatch.py). Without a uv the model
evaluates to zero, as the reference's does where its caller passes none.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.core import math as m
from mitsuba_tpu_torch.core import warp
from mitsuba_tpu_torch.core.noise import MASK32, mul32, perlin_noise, u32
from mitsuba_tpu_torch.io.weave import EWARP, EWEFT, WeavePattern, Yarn

_EPS = 1e-7

# the per-material globals row
(G_ALPHA, G_BETA, G_SS, G_HWIDTH, G_WARPAREA, G_WEFTAREA,
 G_DWP_DWP, G_DWP_DWF, G_DWF_DWP, G_DWF_DWF,
 G_PERIOD, G_FINENESS, G_REPU, G_REPV, G_KDMULT, G_KSMULT,
 G_TILEW, G_TILEH, G_NGLOBALS) = range(19)

# the per-yarn-segment row
(Y_TYPE, Y_PSI, Y_UMAX, Y_KAPPA, Y_WIDTH, Y_LENGTH, Y_CU, Y_CV,
 Y_NFIELDS) = range(9)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_patterns(specs):
    """The cloth specs (dicts of pattern (WeavePattern), repeat_u,
    repeat_v, kd_mult, ks_mult) as shared tables padded to the largest
    tile and yarn count: grid (NC, THmax, TWmax) int32 0-based yarn
    index, yarn (NC, Ymax, Y_NFIELDS), kd and ks (NC, Ymax, 3), gl (NC,
    G_NGLOBALS) float32 tensors; None without specs."""
    if not specs:
        return None
    nc = len(specs)
    twm = max(s["pattern"].tileWidth for s in specs)
    thm = max(s["pattern"].tileHeight for s in specs)
    ym = max(len(s["pattern"].yarns) for s in specs)
    grid = np.zeros((nc, thm, twm), np.int32)
    yarn = np.zeros((nc, ym, Y_NFIELDS), np.float32)
    kd = np.zeros((nc, ym, 3), np.float32)
    ks = np.zeros((nc, ym, 3), np.float32)
    gl = np.zeros((nc, G_NGLOBALS), np.float32)
    for i, s in enumerate(specs):
        w = s["pattern"]
        g = w.grid()
        # the real pattern in the padded grid's corner: lookups take it
        # modulo the real dims (in gl)
        grid[i, :g.shape[0], :g.shape[1]] = g
        for j, y in enumerate(w.yarns):
            yarn[i, j] = (y.type, y.psi, y.umax, y.kappa, y.width,
                          y.length, y.centerU, y.centerV)
            kd[i, j] = y.kd
            ks[i, j] = y.ks
        gl[i] = (w.alpha, w.beta, w.ss, w.hWidth, w.warpArea, w.weftArea,
                 w.dWarpUmaxOverDWarp, w.dWarpUmaxOverDWeft,
                 w.dWeftUmaxOverDWarp, w.dWeftUmaxOverDWeft,
                 w.period, w.fineness, s["repeat_u"], s["repeat_v"],
                 s["kd_mult"], s["ks_mult"], w.tileWidth, w.tileHeight)
    return {k: torch.as_tensor(v) for k, v in
            dict(grid=grid, yarn=yarn, kd=kd, ks=ks, gl=gl).items()}


def procedural_pattern(kind: str = "plain", warp_kd=(0.3, 0.27, 0.25),
                       weft_kd=(0.6, 0.1, 0.1), ks=(0.2, 0.2, 0.2)):
    """A WeavePattern for the procedural plain or twill weave (the
    reference requires a pattern file; the JAX package adds these): one
    staple yarn segment a tile cell, centred in its cell."""
    if kind == "twill":
        tw = th = 4
        is_warp = [[(x - y) % 4 < 2 for x in range(tw)] for y in range(th)]
    else:
        tw = th = 2
        is_warp = [[(x + y) % 2 == 0 for x in range(tw)] for y in range(th)]
    w = WeavePattern(name=f"procedural-{kind}", tileWidth=tw, tileHeight=th,
                     alpha=0.05, beta=2.0, ss=0.3, hWidth=0.5,
                     warpArea=0.5, weftArea=0.5, fineness=0.0, period=0.0)
    deg = np.pi / 180.0
    for y in range(th):
        for x in range(tw):
            warp_cell = is_warp[y][x]
            w.pattern.append(len(w.yarns) + 1)
            w.yarns.append(Yarn(
                type=EWARP if warp_cell else EWEFT,
                psi=30.0 * deg, umax=35.0 * deg, kappa=0.0,
                width=1.0, length=1.2,
                centerU=(x + 0.5) / tw, centerV=1.0 - (y + 0.5) / th,
                kd=tuple(warp_kd) if warp_cell else tuple(weft_kd),
                ks=tuple(ks)))
    return w


# ---------------------------------------------------------------------------
# the model's pieces (per lane, branchless)
# ---------------------------------------------------------------------------

def _safe_div(a, b, eps=1e-9):
    """a / b with |b| clamped away from 0, keeping b's sign."""
    s = torch.where(b >= 0, 1.0, -1.0)
    return a / (s * torch.clamp(torch.abs(b), min=eps))


def _von_mises(cos_x, b):
    """exp(b cos x) / (2 pi I0(b)) in the log domain (irawan.cpp:489;
    Abramowitz & Stegun 9.8.1 and 9.8.2)."""
    ab = torch.abs(b)
    t = (ab / 3.75) ** 2
    i0_small = 1.0 + t * (3.5156229 + t * (3.0899424 + t * (1.2067492
        + t * (0.2659732 + t * (0.0360768 + t * 0.0045813)))))
    tl = 3.75 / torch.clamp(ab, min=3.75)
    p_large = 0.39894228 + tl * (0.01328592 + tl * (0.00225319
        + tl * (-0.00157565 + tl * (0.00916281 + tl * (-0.02057706
        + tl * (0.02635537 + tl * (-0.01647633 + tl * 0.00392377)))))))
    log_i0 = torch.where(
        ab <= 3.75,
        torch.log(torch.clamp(i0_small, min=1e-30)),
        ab - 0.5 * torch.log(torch.clamp(ab, min=1e-9))
        + torch.log(torch.clamp(p_large, min=1e-30)))
    return torch.exp(b * cos_x - log_i0) / (2.0 * math.pi)


def _seeliger(cos1, cos2):
    """Lommel-Seeliger attenuation of albedo 1 (irawan.cpp:510)."""
    c1 = torch.clamp(cos1, min=0.0)
    c2 = torch.clamp(cos2, min=0.0)
    prod = c1 * c2
    return torch.where(
        prod > 0.0, prod / (4.0 * math.pi * torch.clamp(c1 + c2, min=_EPS)),
        0.0)


def _smooth_step(x):
    t = torch.clamp(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _radius_of_curvature(u, umax, kappa, w, l):
    """The yarn spine's radius of curvature at inclination u: an ellipse,
    a parabola, a hyperbola or a circle by rhat = 1 + kappa (1 + 1 / tan
    umax) (irawan.cpp:455), all four evaluated and one selected."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / torch.tan(torch.clamp(umax, min=1e-4)))
    a = 0.5 * w
    sin_umax = torch.sin(umax)
    arc = 0.5 * l - a * sin_umax
    r_circ = _safe_div(arc, sin_umax)
    # the ellipse (rhat > 0): t = atan(rhat tan u)
    rh_pos = torch.clamp(rhat, min=1e-6)
    tmax_e = torch.atan(rh_pos * torch.tan(umax))
    bhat_e = _safe_div(arc, torch.sin(tmax_e))
    ahat_e = bhat_e / rh_pos
    t_e = torch.atan(rh_pos * torch.tan(u))
    ct, st = torch.cos(t_e), torch.sin(t_e)
    r_ell = _safe_div((bhat_e ** 2 * ct * ct
                       + ahat_e ** 2 * st * st) ** 1.5, ahat_e * bhat_e)
    # the hyperbola (rhat < 0): t = -atanh(rhat tan u)
    rh_neg = torch.clamp(rhat, max=-1e-6)
    arg_m = torch.clamp(rh_neg * torch.tan(umax), -1.0 + 1e-6, 1.0 - 1e-6)
    tmax_h = -torch.atanh(arg_m)
    bhat_h = _safe_div(arc, torch.sinh(tmax_h))
    ahat_h = bhat_h / rh_neg
    arg_u = torch.clamp(rh_neg * torch.tan(u), -1.0 + 1e-6, 1.0 - 1e-6)
    t_h = -torch.atanh(arg_u)
    ch, sh = torch.cosh(t_h), torch.sinh(t_h)
    r_hyp = -_safe_div((bhat_h ** 2 * ch * ch
                        + ahat_h ** 2 * sh * sh) ** 1.5, ahat_h * bhat_h)
    # the parabola (rhat = 0)
    tmax_p = torch.tan(umax)
    ahat_p = _safe_div(arc, 2.0 * tmax_p)
    t_p = torch.tan(u)
    r_par = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5
    return torch.where(
        torch.abs(rhat - 1.0) < 1e-6, r_circ,
        torch.where(rhat > 1e-6, r_ell,
                    torch.where(rhat < -1e-6, r_hyp, r_par)))


def _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax, kappa,
                        w, l, h_width):
    """The specular integrand of untwisted filament yarns (irawan.cpp:
    292-357): the reflecting inclination u(v) from the half vector, the
    highlight a band of constant width delta_y along the segment."""
    ok = ((ss >= 0.0) & (ss < 1.0) & (w * torch.sin(umax) < l)
          & (kappa >= -1.0))
    h = m.normalize(om_i + om_r)
    u_of_v = torch.atan(_safe_div(h[..., 1], h[..., 2]))
    in_rng = torch.abs(u_of_v) < umax
    cu, su = torch.cos(u_of_v), torch.sin(u_of_v)
    cv, sv = torch.cos(v), torch.sin(v)
    n = m.normalize(torch.stack([sv, su * cv, cu * cv], -1))
    r_curv = _radius_of_curvature(
        torch.minimum(torch.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w, l)
    a = 0.5 * w
    len_ior = m.length(om_i + om_r)
    # cross(t, h).x of the fibre tangent t = (0, cos u, -sin u)
    txh_x = cu * h[..., 2] + su * h[..., 1]
    g_u = _safe_div(a * (r_curv + a * cv),
                    len_ior * torch.clamp(torch.abs(txh_x), min=_EPS))
    fc = alpha + _von_mises(-m.dot(om_i, om_r), beta)
    att = _seeliger(m.dot(n, om_i), m.dot(n, om_r))
    smooth = 1.0 - _smooth_step(
        _safe_div(torch.abs(u_of_v) - (1.0 - ss) * umax,
                  ss * torch.clamp(umax, min=1e-6)))
    att_s = torch.where(ss > 0.0, att * smooth, att)
    fs = g_u * fc * att_s * math.pi * l
    delta_y = l * h_width
    y_of_v = torch.clamp(u_of_v * 0.5 * l / torch.clamp(umax, min=1e-6),
                         0.5 * (delta_y - l), 0.5 * (l - delta_y))
    on_hl = torch.abs(
        y_of_v - u * 0.5 * l / torch.clamp(umax, min=1e-6)) < 0.5 * delta_y
    return torch.where(ok & in_rng & on_hl, _safe_div(fs, delta_y), 0.0)


def _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax, kappa,
                      w, l, h_width):
    """The specular integrand of twisted staple yarns (irawan.cpp:
    373-441): the reflecting azimuth v(u) from the twisted fibre's mirror
    condition, the highlight a band of constant width delta_x across the
    segment."""
    ok = (w * torch.sin(umax) < l) & (kappa >= -1.0)
    h = m.normalize(om_i + om_r)
    cu, su = torch.cos(u), torch.sin(u)
    hy, hz = h[..., 1], h[..., 2]
    denom = torch.sqrt(h[..., 0] ** 2 + (hy * su + hz * cu) ** 2)
    tan_psi = torch.tan(psi)
    d_val = _safe_div(hy * cu - hz * su,
                      denom * torch.where(torch.abs(tan_psi) > _EPS,
                                          tan_psi, 1.0))
    v_of_u = (torch.atan2(-hy * su - hz * cu, h[..., 0])
              + torch.arccos(torch.clamp(d_val, -1.0, 1.0)))
    in_rng = (torch.abs(d_val) < 1.0) & (torch.abs(v_of_u) < math.pi / 2.0)
    cvu, svu = torch.cos(v_of_u), torch.sin(v_of_u)
    n = m.normalize(torch.stack([svu, su * cvu, cu * cvu], -1))
    r_curv = _radius_of_curvature(torch.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    len_ior = m.length(om_i + om_r)
    g_v = _safe_div(
        a * (r_curv + a * cvu),
        len_ior * m.dot(n, h)
        * torch.clamp(torch.abs(torch.sin(psi)), min=_EPS))
    fc = alpha + _von_mises(-m.dot(om_i, om_r), beta)
    att = _seeliger(m.dot(n, om_i), m.dot(n, om_r))
    fs = g_v * fc * att * 2.0 * w * umax
    delta_x = w * h_width
    x_of_u = torch.clamp(v_of_u * w / math.pi,
                         0.5 * (delta_x - w), 0.5 * (w - delta_x))
    on_hl = torch.abs(x_of_u - v * w / math.pi) < 0.5 * delta_x
    return torch.where(ok & in_rng & on_hl, _safe_div(fs, delta_x), 0.0)


# ---------------------------------------------------------------------------
# the counter-based hash of the reference's seeded PRNGs
# ---------------------------------------------------------------------------

def _hash01(x):
    """A uint32 (int64 in [0, 2^32)) -> uniform (0, 1) by a PCG output
    permutation (irawan.py:290): its shift depends on the lane."""
    x = (mul32(x & MASK32, 747796405) + 2891336453) & MASK32
    sh = (x >> 28) + 4
    x = mul32((x >> sh) ^ x, 277803737)
    x = (x >> 22) ^ x
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)


def _i32(x):
    """A float's value cast to int32 (truncated toward zero), int64."""
    return x.to(torch.int32).to(torch.int64)


# ---------------------------------------------------------------------------
# the BSDF's entry points (per lane)
# ---------------------------------------------------------------------------

def _cell(p, uv):
    """The lane's (globals row, tile x, tile y, tile width and height,
    hit segment id): irawan.cpp:109-119, uv.y flipped, scaled by the
    repeats, the yarn looked up in the tile's cell."""
    c = p["_cloth"]
    slot = torch.clamp(p["_cloth_slot"], 0, c["gl"].shape[0] - 1).long()
    gl = c["gl"][slot]
    tw = gl[..., G_TILEW]
    th = gl[..., G_TILEH]
    x = uv[..., 0] * gl[..., G_REPU] * tw
    y = (1.0 - uv[..., 1]) * gl[..., G_REPV] * th
    lx = torch.remainder(torch.floor(x), tw).long()
    ly = torch.remainder(torch.floor(y), th).long()
    yid = c["grid"][slot, ly, lx].long()
    return c, slot, gl, x, y, tw, th, yid


def irawan_eval(p, wi, wo):
    """fCos of the Irawan cloth model (irawan.cpp:107 f() times cos)."""
    uv = p.get("_uv")
    if p.get("_cloth") is None or uv is None:
        return torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    upper = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)
    c, slot, gl, x, y, tw, th, yid = _cell(p, uv)
    yarn = c["yarn"][slot, yid]
    kd = c["kd"][slot, yid]
    ks = c["ks"][slot, yid]
    is_weft = yarn[..., Y_TYPE] > 0.5
    # segment-centred coordinates (irawan.cpp:121-131)
    center_x = torch.floor(x / tw) * tw + yarn[..., Y_CU] * tw
    center_y = torch.floor(y / th) * th + (1.0 - yarn[..., Y_CV]) * th
    xx = x - center_x
    yy = -(y - center_y)
    # a weft segment turns its frame and the directions pi/2 about z
    xx, yy = torch.where(is_weft, -yy, xx), torch.where(is_weft, xx, yy)

    def rot(v):
        return torch.where(is_weft[..., None], torch.stack(
            [-v[..., 1], v[..., 0], v[..., 2]], -1), v)

    om_i = rot(wi)
    om_r = rot(wo)
    psi = yarn[..., Y_PSI]
    umax = yarn[..., Y_UMAX]
    kappa = yarn[..., Y_KAPPA]
    w_seg = yarn[..., Y_WIDTH]
    l_seg = yarn[..., Y_LENGTH]
    d_wp = torch.where(is_weft, gl[..., G_DWF_DWP], gl[..., G_DWP_DWP])
    d_wf = torch.where(is_weft, gl[..., G_DWF_DWF], gl[..., G_DWP_DWF])
    # the correlated umax noise of a yarn segment (irawan.cpp:165-184),
    # hashed from its centre (a negative centre wraps as the reference's
    # int32 -> uint32 cast does)
    period = gl[..., G_PERIOD]
    safe_period = torch.clamp(period, min=1e-6)
    seed_p = (mul32(u32(_i32(center_x)), u32(_i32(th * gl[..., G_REPV])))
              + u32(_i32(center_y))) & MASK32
    r1 = _hash01(seed_p)
    r2 = _hash01(seed_p ^ 0x9E3779B9)
    zero = torch.zeros_like(r1)
    pn1 = perlin_noise(torch.stack(
        [(center_x * (th * gl[..., G_REPV] + r1) + center_y) / safe_period,
         zero, zero], -1))
    pn2 = perlin_noise(torch.stack(
        [(center_y * (tw * gl[..., G_REPU] + r2) + center_x) / safe_period,
         zero, zero], -1))
    umax = umax + torch.where(period > 0.0, pn1 * d_wp + pn2 * d_wf, 0.0)
    # the parametric spot on the segment (irawan.cpp:187-189)
    u = yy / (0.5 * l_seg) * umax
    v = xx * math.pi / w_seg
    fil = _filament_integrand(u, v, om_i, om_r, gl[..., G_ALPHA],
                              gl[..., G_BETA], gl[..., G_SS], umax, kappa,
                              w_seg, l_seg, gl[..., G_HWIDTH])
    stp = _staple_integrand(u, v, om_i, om_r, gl[..., G_ALPHA],
                            gl[..., G_BETA], psi, umax, kappa,
                            w_seg, l_seg, gl[..., G_HWIDTH])
    integrand = torch.where(psi != 0.0, stp, fil)
    # the specular intensity's variation (irawan.cpp:203-216): Exp(1)
    # noise a fineness cell, clamped at 10
    fine = gl[..., G_FINENESS]
    i1 = _i32(torch.floor((center_x + xx) * fine))
    i2 = _i32(torch.floor((center_y + yy) * fine))
    kf = _i32(th * gl[..., G_REPV] * fine)
    xi = _hash01((i1 * kf + i2) & MASK32)
    ivar = torch.where(fine > 0.0, torch.clamp(-torch.log(xi), max=10.0),
                       1.0)
    area_w = gl[..., G_WARPAREA]
    area_f = gl[..., G_WEFTAREA]
    ratio = _safe_div(area_w + area_f, torch.where(is_weft, area_f, area_w))
    spec = ks * (ivar * gl[..., G_KSMULT] * integrand * ratio)[..., None]
    f_val = spec + kd * gl[..., G_KDMULT][..., None]
    co = torch.clamp(m.cos_theta(wo), min=0.0)
    return torch.where(upper[..., None], f_val * co[..., None], 0.0)


def irawan_pdf(p, wi, wo):
    """The cosine hemisphere's pdf (irawan.cpp:239)."""
    valid = (m.cos_theta(wi) > 0) & (m.cos_theta(wo) > 0)
    return torch.where(valid, m.cos_theta(wo) * m.INV_PI, 0.0)


def irawan_sample(p, wi, u2, u1):
    """Cosine-weighted sampling (irawan.cpp:245), weighted by eval / pdf."""
    from mitsuba_tpu_torch.bsdfs.models import _mask3, zero_sample

    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (m.cos_theta(wi) > 0) & (pdf > 0)
    fcos = irawan_eval(p, wi, wo)
    s = zero_sample(wi, p["reflectance"].shape[-1])
    s.update(wo=wo,
             weight=_mask3(valid, fcos / torch.clamp(pdf, min=1e-9)[..., None]),
             pdf=torch.where(valid, pdf, 0.0), valid=valid)
    return s


def irawan_diffuse_reflectance(p):
    """kd times kdMultiplier of the lane's yarn segment (irawan.cpp:227
    getDiffuseReflectance)."""
    uv = p.get("_uv")
    if p.get("_cloth") is None or uv is None:
        return p["reflectance"]
    c, slot, gl, _, _, _, _, yid = _cell(p, uv)
    return c["kd"][slot, yid] * gl[..., G_KDMULT][..., None]
