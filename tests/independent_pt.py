"""An INDEPENDENT minimal path tracer, written directly from the rendering
equation (Veach's path-integral formulation) for cross-checking transport.

Shares NO transport code with akari_tpu: its own intersection sweep, its
own cosine-hemisphere sampling (polar-coordinates derivation, different
from sampling.py's concentric-disk mapping), its own NEE with the BALANCE
heuristic (the framework uses the power heuristic — both are unbiased, so
converged means must agree), its own RNG streams (numpy Generator). Only
the compiled scene *data* tables are read (triangles, material kinds,
constant colors).

Limitations by design: diffuse + emissive materials only, constant
textures only, no firefly clamp. Use scenes within that envelope and
compare MEANS within Monte-Carlo noise — a shared-factor bug in the
framework's NEE/MIS (which the numpy oracle structurally cannot catch)
shows up as a biased mean here.
"""

from __future__ import annotations

import numpy as np

from akari_tpu.scene.arrays import MAT_DIFFUSE, MAT_EMISSIVE


def _scene_tables(scene):
    v0 = np.asarray(scene.tri_v0, np.float64)
    e1 = np.asarray(scene.tri_e1, np.float64)
    e2 = np.asarray(scene.tri_e2, np.float64)
    kind = np.asarray(scene.materials.kind)
    color_tex = np.asarray(scene.materials.color_tex)
    tex_val = np.asarray(scene.textures.value, np.float64)
    mat_of = np.asarray(scene.mat_id)
    color = tex_val[color_tex[mat_of]]          # [T,3] per-triangle albedo/Le
    mkind = kind[mat_of]                        # [T]
    dsided = np.asarray(scene.materials.double_sided)[mat_of].astype(bool)
    return v0, e1, e2, color, mkind, dsided


def _intersect(o, d, v0, e1, e2, t_min=1e-4, t_max=1e30):
    """Closest hit of rays [N,3] against ALL triangles. Fresh MT sweep."""
    # [N,T] pairwise
    pv = np.cross(d[:, None, :], e2[None, :, :])
    det = np.einsum("tc,ntc->nt", e1, pv)
    inv = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
    tv = o[:, None, :] - v0[None, :, :]
    u = np.einsum("ntc,ntc->nt", tv, pv) * inv
    qv = np.cross(tv, e1[None, :, :])
    v = np.einsum("nc,ntc->nt", d, qv) * inv
    t = np.einsum("tc,ntc->nt", e2, qv) * inv
    ok = (
        (np.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > t_min) & (t < t_max)
    )
    t = np.where(ok, t, np.inf)
    prim = np.argmin(t, axis=1)
    tbest = t[np.arange(t.shape[0]), prim]
    hit = np.isfinite(tbest)
    return hit, np.where(hit, prim, -1), np.where(hit, tbest, np.inf)


def _occluded(o, d, dist, v0, e1, e2):
    hit, _, t = _intersect(o, d, v0, e1, e2, t_min=1e-4, t_max=1e30)
    return hit & (t < dist * (1.0 - 1e-3))


def _cosine_dir(n, rng):
    """Cosine-weighted directions about normals [N,3] — polar mapping."""
    u1 = rng.random(n.shape[0])
    u2 = rng.random(n.shape[0])
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    local = np.stack(
        [r * np.cos(phi), r * np.sin(phi), np.sqrt(np.maximum(1 - u1, 0))], -1
    )
    # build ONB via Gram-Schmidt on an arbitrary helper axis
    h = np.where(np.abs(n[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    t1 = np.cross(h, n)
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    return local[:, 0:1] * t1 + local[:, 1:2] * t2 + local[:, 2:3] * n


def render_independent(scene, camera, spp, max_depth, seed=0):
    """[H,W,3] mean radiance. Diffuse/emissive-only scenes."""
    v0, e1, e2, color, mkind, dsided = _scene_tables(scene)
    ngs = np.cross(e1, e2)
    area2 = np.linalg.norm(ngs, axis=-1)          # 2*area
    ng_unit = ngs / np.maximum(area2, 1e-30)[:, None]

    # light set: emissive ORIGINAL triangles (SBVH may store duplicate
    # copies of one triangle; enumerate each physical emitter once), each
    # selected proportional to power. tri_light maps EVERY storage copy of
    # an emitter to its light index so BSDF-hit MIS is copy-invariant.
    orig = np.asarray(scene.prim_to_orig)
    first_copy = np.zeros(orig.max() + 1, np.int64)
    seen = np.zeros(orig.max() + 1, bool)
    for slot in range(orig.shape[0]):
        if not seen[orig[slot]]:
            seen[orig[slot]] = True
            first_copy[orig[slot]] = slot
    orig_em = np.unique(orig[mkind == MAT_EMISSIVE])
    lights = first_copy[orig_em]
    lum = color[lights] @ np.asarray([0.2126, 0.7152, 0.0722])
    power = lum * 0.5 * area2[lights]
    lpmf = power / power.sum()
    lcdf = np.cumsum(lpmf)
    light_of_orig = np.full(orig.max() + 1, -1, np.int64)
    light_of_orig[orig_em] = np.arange(lights.shape[0])
    tri_light = light_of_orig[orig]  # [T] storage slot -> light idx or -1

    h, w = camera.height, camera.width
    c2w = np.asarray(camera.c2w, np.float64)
    thf = float(camera.tan_half_fov)
    sx, sy = (thf, thf * h / w) if w > h else (thf * w / h, thf)
    rng = np.random.default_rng(seed)
    n = h * w
    img = np.zeros((n, 3))

    for _ in range(spp):
        # camera rays (same raster convention as the framework; this part
        # is geometry, not transport)
        px = np.arange(n) % w + rng.random(n)
        py = np.arange(n) // w + rng.random(n)
        ndx = (2 * px / w - 1) * sx
        ndy = (1 - 2 * py / h) * sy
        d = np.stack([ndx, ndy, -np.ones(n)], -1)
        d = d @ c2w[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(c2w[:3, 3], (n, 3)).copy()

        L = np.zeros((n, 3))
        beta = np.ones((n, 3))
        alive = np.ones(n, bool)
        prev_bsdf_pdf = np.zeros(n)  # solid-angle pdf of the sampling that
        spec_first = np.ones(n, bool)  # camera vertex: emission unweighted

        # vertex i = i-th surface hit. Strategies: emission at vertices
        # 0..max_depth, NEE at vertices 0..max_depth-1 (the framework's
        # estimator shape: max_depth bounce steps + trailing emission).
        for _depth in range(max_depth + 1):
            last = _depth == max_depth
            hit, prim, t = _intersect(o, d, v0, e1, e2)
            alive = alive & hit
            if not alive.any():
                break
            pr = np.maximum(prim, 0)
            x = o + d * np.where(np.isfinite(t), t, 0)[:, None]
            ngv = ng_unit[pr]
            front = np.einsum("nc,nc->n", d, ngv) < 0
            nsh = np.where(front[:, None], ngv, -ngv)  # shading = geometric

            # --- emission: MIS-weighted against NEE of the PREVIOUS vertex
            is_em = mkind[pr] == MAT_EMISSIVE
            emit_ok = alive & is_em & (front | dsided[pr])
            if emit_ok.any():
                # pdf of having sampled this point via NEE from prev vertex
                tl = tri_light[pr]
                sel = np.where(tl >= 0, lpmf[np.maximum(tl, 0)], 0.0)
                p_area = sel / np.maximum(0.5 * area2[pr], 1e-30)
                cos_l = np.abs(np.einsum("nc,nc->n", d, ngv))
                t_f = np.where(np.isfinite(t), t, 0.0)  # missed lanes masked
                p_nee_sa = p_area * t_f * t_f / np.maximum(cos_l, 1e-9)
                w_mis = np.where(
                    spec_first, 1.0,
                    prev_bsdf_pdf / np.maximum(prev_bsdf_pdf + p_nee_sa, 1e-30),
                )  # BALANCE heuristic
                L[emit_ok] += beta[emit_ok] * color[pr[emit_ok]] \
                    * w_mis[emit_ok, None]

            # --- continue only on diffuse surfaces
            alive = alive & (mkind[pr] == MAT_DIFFUSE)
            if last or not alive.any():
                break

            # --- NEE with balance-heuristic MIS ---
            usel = rng.random(n)
            li = np.searchsorted(lcdf, usel, side="right")
            li = np.clip(li, 0, len(lights) - 1)
            lt = lights[li]
            # uniform point on the light triangle (sqrt warp, written fresh)
            r1, r2 = rng.random(n), rng.random(n)
            su = np.sqrt(r1)
            b0, b1 = 1 - su, r2 * su
            y = v0[lt] + b0[:, None] * e1[lt] + b1[:, None] * e2[lt]
            wi = y - x
            dist = np.linalg.norm(wi, axis=-1)
            wi = wi / np.maximum(dist, 1e-12)[:, None]
            cos_s = np.einsum("nc,nc->n", nsh, wi)
            cos_l = -np.einsum("nc,nc->n", ng_unit[lt], wi)
            l_front = cos_l > 0
            l_ok = alive & (cos_s > 0) & (l_front | dsided[lt]) & (dist > 1e-6)
            p_area = lpmf[li] / np.maximum(0.5 * area2[lt], 1e-30)
            p_sa = p_area * dist * dist / np.maximum(np.abs(cos_l), 1e-12)
            f = color[pr] / np.pi  # Lambert BRDF
            pdf_bsdf_sa = np.maximum(cos_s, 0.0) / np.pi
            w_nee = p_sa / np.maximum(p_sa + pdf_bsdf_sa, 1e-30)
            contrib = beta * f * color[lt] \
                * (np.maximum(cos_s, 0) / np.maximum(p_sa, 1e-30) * w_nee)[:, None]
            if l_ok.any():
                oo = x + wi * 1e-4 / np.maximum(
                    np.abs(np.einsum("nc,nc->n", ngv, wi)), 1e-4)[:, None]
                occ = _occluded(oo[l_ok], wi[l_ok], dist[l_ok], v0, e1, e2)
                ll = np.zeros(n, bool)
                ll[np.nonzero(l_ok)[0][~occ]] = True
                L[ll] += contrib[ll]

            # --- BSDF sampling: cosine hemisphere ---
            wi2 = _cosine_dir(nsh, rng)
            cos2 = np.maximum(np.einsum("nc,nc->n", nsh, wi2), 0.0)
            pdf2 = cos2 / np.pi
            alive = alive & (pdf2 > 1e-9)
            # f * cos / pdf = albedo for cosine sampling of Lambert
            beta = np.where(alive[:, None], beta * color[pr], beta)
            o = x + wi2 * (1e-4 / np.maximum(
                np.abs(np.einsum("nc,nc->n", ngv, wi2)), 1e-4))[:, None]
            d = wi2
            prev_bsdf_pdf = pdf2
            spec_first = np.zeros(n, bool)

        img += L
    return (img / spp).reshape(h, w, 3)
