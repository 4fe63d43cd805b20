"""Fused per-pixel render kernel for the GPU (Pallas, Triton route).

The same design as the reference's one ``@cuda.jit`` global ``render`` kernel
(reference kernels.py:6-73): every lane of a program owns one pixel and runs its
whole chain in registers — analytic ray generation, the 3x3 AA samples, the
closest-hit sweep over every sphere and plane, one shadow sweep per light, and
the ``depth`` mirror bounces — then writes its float rgb once. Nothing between
ray generation and the final value goes to device memory, where the jnp path
(ops/render.py) materialises ``(rays, objects)`` distance arrays for every
sweep.

* A program takes ``_BLOCK`` consecutive pixels of the flattened ``(w, h)``
  image (column-major in the reference's ``(x, y)`` indexing, so a warp walks
  down one image column and its rays stay coherent). The pixel count is padded
  to a whole number of blocks; the padding is sliced off afterwards.
* Ray generation is analytic in the *global* pixel index: ``x_offset`` /
  ``local_width`` render a vertical slice of the image, which is what the
  ray-data-parallel shard path (parallel/render_sharded.py) runs per device.
* Camera, materials and the scene's structure-of-arrays live in one float32
  table, padded to a power of two and read whole from global memory (a few
  hundred bytes; the L1 cache serves every lane). Materials and camera are
  traced values: changing them does not recompile.
* Objects, lights, AA samples and bounces are ``lax.fori_loop`` loops, as the
  reference's per-thread loops are; the kernel code holds one copy of the
  trace.

The arithmetic mirrors the jnp path term for term (same quadratic, same
renormalisations, same 999.0 far clip, strict-< closest hit with spheres
before planes, unlimited-range shadow rays, 2e-4 acne biases, the compat AA
G/B swaps — see ops/render.py), so the two differ only where a different
float32 association flips a near-tied hit test at a silhouette.

:func:`render_image_fast` wraps the kernel in a ``jax.custom_vjp`` whose
backward is XLA's autodiff of the jnp path.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..render import _AA_OFFSETS, render_image

BIG = 1e30
FAR = 999.0
BIAS = 2e-4

_BLOCK = 128       # pixels per program: one per thread at 4 warps
_NUM_WARPS = 4

# Table layout: fixed header, then the scene's attribute rows.
_P_ORIGIN = 0      # 3: camera origin
_P_ROT = 3         # 9: world-from-camera rotation, row-major
_P_FOCAL = 12
_P_Y0, _P_DY, _P_Z0, _P_DZ = 13, 14, 15, 16
_P_AMB, _P_LAMB, _P_REFL = 17, 18, 19
_P_SPEC, _P_SHIN = 20, 21   # Phong specular/shininess (clean mode only)
_P_X0 = 22         # global x index of the slice's first column
_P_OFFS = 23       # 2*9: AA sample offsets, the centre sample first
_HEADER = 48       # header length, padded past _P_OFFS + 18
_SPHERE_ROWS = 7   # cx, cy, cz, r, albedo r, g, b
_PLANE_ROWS = 9    # origin xyz, normal xyz, albedo rgb
_LIGHT_ROWS = 3    # position xyz

_SAMPLE_OFFSETS = ((0.0, 0.0),) + _AA_OFFSETS


def _layout(ns: int, npl: int, nl: int):
    """Base offsets of the sphere, plane and light rows, and the padded size."""
    sph = _HEADER
    pln = sph + _SPHERE_ROWS * ns
    lts = pln + _PLANE_ROWS * npl
    end = lts + _LIGHT_ROWS * nl
    return sph, pln, lts, int(pl.next_power_of_2(end))


def _pack_table(camera, scene, compat, x_offset):
    """Camera, materials and scene -> one float32 table (see _layout)."""
    focal, y0, dy, z0, dz = camera.grid_params(compat)
    m = scene.materials
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    header = jnp.concatenate([
        f32(camera.position).reshape(3),
        f32(camera.rotation).reshape(9),
        jnp.stack([f32(v) for v in (focal, y0, dy, z0, dz, m.ambient,
                                    m.lambert, m.reflection, m.specular,
                                    m.shininess, x_offset)]),
        jnp.asarray(_SAMPLE_OFFSETS, jnp.float32).reshape(-1),
    ])
    rows = [header, jnp.zeros((_HEADER - header.shape[0],), jnp.float32)]
    if scene.spheres.count:
        rows += [f32(scene.spheres.center).T.reshape(-1),
                 f32(scene.spheres.radius).reshape(-1),
                 f32(scene.spheres.albedo).T.reshape(-1)]
    if scene.planes.count:
        rows += [f32(scene.planes.origin).T.reshape(-1),
                 f32(scene.planes.normal).T.reshape(-1),
                 f32(scene.planes.albedo).T.reshape(-1)]
    if scene.lights.count:
        rows.append(f32(scene.lights.position).T.reshape(-1))
    tab = jnp.concatenate(rows)
    size = _layout(scene.spheres.count, scene.planes.count,
                   scene.lights.count)[3]
    return jnp.pad(tab, (0, size - tab.shape[0]))


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    """Unit vector, with a zero vector left at zero (== ops/shade._normalize)."""
    n2 = _dot(x, y, z, x, y, z)
    n = jnp.sqrt(jnp.where(n2 > 0.0, n2, 1.0))
    return x / n, y / n, z / n


def _unit(x, y, z):
    """Plain normalisation (== the compat renormalisation in ops/intersect)."""
    n = jnp.sqrt(_dot(x, y, z, x, y, z))
    return x / n, y / n, z / n


def _make_kernel(*, W, H, ns, npl, nl, depth, aliasing, compat):
    """Kernel for one static scene shape; see the module docstring."""
    SPH, PLN, LTS, _ = _layout(ns, npl, nl)
    f32, i32 = jnp.float32, jnp.int32
    plane_eps = 1e-3 if compat else 1e-8

    def kernel(tab, r_out, g_out, b_out):
        ld = lambda k: tab[k]

        def sphere_t(j, ox, oy, oz, dx, dy, dz, a, inv2a):
            """Distance to sphere ``j`` (== ops/intersect.intersect_spheres)."""
            lx = ox - ld(SPH + j)
            ly = oy - ld(SPH + ns + j)
            lz = oz - ld(SPH + 2 * ns + j)
            r = ld(SPH + 3 * ns + j)
            b = 2.0 * _dot(lx, ly, lz, dx, dy, dz)
            c = _dot(lx, ly, lz, lx, ly, lz) - r * r
            disc = b * b - 4.0 * a * c
            has_root = disc >= 0.0
            sq = jnp.sqrt(jnp.where(has_root, disc, 0.0))
            near_pos = (-b - sq) > 0.0
            far_pos = (-b + sq) > 0.0
            t = jnp.where(near_pos, (-b - sq) * inv2a, (-b + sq) * inv2a)
            return t, has_root & (near_pos | far_pos)

        def plane_t(j, ox, oy, oz, dx, dy, dz):
            """Distance to plane ``j`` (== ops/intersect.intersect_planes)."""
            nx = ld(PLN + 3 * npl + j)
            ny = ld(PLN + 4 * npl + j)
            nz = ld(PLN + 5 * npl + j)
            den = _dot(dx, dy, dz, nx, ny, nz)
            num = _dot(ld(PLN + j) - ox, ld(PLN + npl + j) - oy,
                       ld(PLN + 2 * npl + j) - oz, nx, ny, nz)
            t = num / jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
            return t, (jnp.abs(den) >= plane_eps) & (t > 0.0)

        def sphere_ray(dx, dy, dz):
            """Direction and quadratic terms the sphere tests use."""
            if compat:
                dx, dy, dz = _unit(dx, dy, dz)
            a = _dot(dx, dy, dz, dx, dy, dz)
            two_a = 2.0 * a
            inv2a = 1.0 / jnp.where(jnp.abs(two_a) > 1e-30, two_a, 1.0)
            return dx, dy, dz, a, inv2a

        def closest_hit(ox, oy, oz, dx, dy, dz):
            """-> (t, obj): nearest valid hit over [spheres ++ planes]."""
            t0 = jnp.full(ox.shape, FAR if compat else BIG, f32)
            obj0 = jnp.zeros(ox.shape, i32)
            sdx, sdy, sdz, a, inv2a = sphere_ray(dx, dy, dz)

            def sph_body(j, st):
                t, obj = st
                tj, ok = sphere_t(j, ox, oy, oz, sdx, sdy, sdz, a, inv2a)
                closer = ok & (tj < t)
                return jnp.where(closer, tj, t), jnp.where(closer, j, obj)

            def pln_body(j, st):
                t, obj = st
                tj, ok = plane_t(j, ox, oy, oz, dx, dy, dz)
                closer = ok & (tj < t)
                return jnp.where(closer, tj, t), jnp.where(closer, ns + j, obj)

            st = (t0, obj0)
            if ns:
                st = jax.lax.fori_loop(0, ns, sph_body, st)
            if npl:
                st = jax.lax.fori_loop(0, npl, pln_body, st)
            return st

        def occluded(ox, oy, oz, dx, dy, dz):
            """Shadow test (== ops/intersect.any_hit): any valid hit, compat
            far clip, no maximum distance. Returns a float 0/1 mask."""
            occ = jnp.zeros(ox.shape, f32)
            sdx, sdy, sdz, a, inv2a = sphere_ray(dx, dy, dz)

            def hit(tj, ok):
                if compat:
                    ok = ok & (tj < FAR)
                return ok

            def sph_body(j, occ):
                tj, ok = sphere_t(j, ox, oy, oz, sdx, sdy, sdz, a, inv2a)
                return jnp.where(hit(tj, ok), 1.0, occ)

            def pln_body(j, occ):
                tj, ok = plane_t(j, ox, oy, oz, dx, dy, dz)
                return jnp.where(hit(tj, ok), 1.0, occ)

            if ns:
                occ = jax.lax.fori_loop(0, ns, sph_body, occ)
            if npl:
                occ = jax.lax.fori_loop(0, npl, pln_body, occ)
            return occ

        def gather(base, count, idx):
            return tab[base + jnp.clip(idx, 0, count - 1)]

        def reflect(dx, dy, dz, nx, ny, nz):
            ddn = 2.0 * _dot(dx, dy, dz, nx, ny, nz)
            return _normalize(dx - ddn * nx, dy - ddn * ny, dz - ddn * nz)

        def trace(ox, oy, oz, dx, dy, dz):
            """One shading evaluation (== ops/shade.trace_once).

            Returns ``(r, g, b, next origin xyz, next direction xyz, alive)``."""
            t, obj = closest_hit(ox, oy, oz, dx, dy, dz)
            alive = t < (FAR if compat else BIG)
            ts = jnp.where(alive, t, 0.0)
            px, py, pz = ox + ts * dx, oy + ts * dy, oz + ts * dz
            zero = jnp.zeros(ox.shape, f32)
            if ns:
                sx, sy, sz = _normalize(px - gather(SPH, ns, obj),
                                        py - gather(SPH + ns, ns, obj),
                                        pz - gather(SPH + 2 * ns, ns, obj))
                sa = [gather(SPH + (4 + c) * ns, ns, obj) for c in range(3)]
            if npl:
                k = obj - ns
                pn = [gather(PLN + (3 + c) * npl, npl, k) for c in range(3)]
                pa = [gather(PLN + (6 + c) * npl, npl, k) for c in range(3)]
            if ns and npl:
                is_plane = obj >= ns
                nx, ny, nz = (jnp.where(is_plane, p, s)
                              for p, s in zip(pn, (sx, sy, sz)))
                alb = [jnp.where(is_plane, p, s) for p, s in zip(pa, sa)]
            elif ns:
                nx, ny, nz, alb = sx, sy, sz, sa
            elif npl:
                (nx, ny, nz), alb = pn, pa
            else:
                nx = ny = nz = zero
                alb = [zero] * 3

            amb = ld(_P_AMB)
            r, g, b = amb * alb[0], amb * alb[1], amb * alb[2]
            qx, qy, qz = px + BIAS * nx, py + BIAS * ny, pz + BIAS * nz
            rx, ry, rz = reflect(dx, dy, dz, nx, ny, nz)
            if nl:
                def light_body(l, acc):
                    lam_sum, spec_sum = acc
                    lx, ly, lz = _normalize(ld(LTS + l) - qx,
                                            ld(LTS + nl + l) - qy,
                                            ld(LTS + 2 * nl + l) - qz)
                    lit = occluded(qx, qy, qz, lx, ly, lz) < 0.5
                    lam = ld(_P_LAMB) * _dot(lx, ly, lz, nx, ny, nz)
                    lam_sum = lam_sum + jnp.where(lit & (lam > 0.0), lam, 0.0)
                    if not compat:
                        # Phong highlight, pow as masked exp/log (== shade.py)
                        spec = _dot(lx, ly, lz, rx, ry, rz)
                        smask = lit & (spec > 0.0)
                        s_safe = jnp.where(smask, spec, 1.0)
                        p = jnp.exp(ld(_P_SHIN) * jnp.log(s_safe))
                        spec_sum = spec_sum + jnp.where(smask, p, 0.0)
                    return lam_sum, spec_sum

                lam_sum, spec_sum = jax.lax.fori_loop(0, nl, light_body,
                                                      (zero, zero))
                r = r + lam_sum * alb[0]
                g = g + lam_sum * alb[1]
                b = b + lam_sum * alb[2]
                if not compat:
                    phong = ld(_P_SPEC) * spec_sum
                    r, g, b = r + phong, g + phong, b + phong
            qx, qy, qz = qx + BIAS * rx, qy + BIAS * ry, qz + BIAS * rz
            r = jnp.where(alive, r, 0.0)
            g = jnp.where(alive, g, 0.0)
            b = jnp.where(alive, b, 0.0)
            return r, g, b, qx, qy, qz, rx, ry, rz, alive.astype(f32)

        def sample(px, py):
            """Primary trace + ``depth`` bounces (== ops/shade.sample)."""
            rot = [ld(_P_ROT + k) for k in range(9)]
            cx = ld(_P_FOCAL)
            cy = ld(_P_Y0) + px * ld(_P_DY)
            cz = ld(_P_Z0) + py * ld(_P_DZ)
            dx, dy, dz = _unit(rot[0] * cx + rot[1] * cy + rot[2] * cz,
                               rot[3] * cx + rot[4] * cy + rot[5] * cz,
                               rot[6] * cx + rot[7] * cy + rot[8] * cz)
            ones = jnp.ones(px.shape, f32)
            ox, oy, oz = (ld(_P_ORIGIN + k) * ones for k in range(3))
            refl = ld(_P_REFL)

            def level(_, st):
                ox, oy, oz, dx, dy, dz, r, g, b, w, alive = st
                tr, tg, tb, ox, oy, oz, dx, dy, dz, hit = trace(
                    ox, oy, oz, dx, dy, dz)
                r, g, b = r + w * tr, g + w * tg, b + w * tb
                alive = alive * hit
                # bounce i+1 is weighted refl**(i+1), gated on every
                # earlier trace having hit
                w = w * refl * alive
                return ox, oy, oz, dx, dy, dz, r, g, b, w, alive

            zero = jnp.zeros(px.shape, f32)
            st = (ox, oy, oz, dx, dy, dz, zero, zero, zero, ones, ones)
            st = jax.lax.fori_loop(0, depth + 1, level, st)
            return st[6], st[7], st[8]

        pix = pl.program_id(0) * _BLOCK + jnp.arange(_BLOCK, dtype=i32)
        col = jax.lax.div(pix, jnp.int32(H))
        gx = (col.astype(f32) + ld(_P_X0))
        gy = (pix - col * H).astype(f32)

        pr, pg, pb = sample(gx, gy)
        if compat:
            pg, pb = pb, pg        # store swap (common.py:61-63)
        if aliasing:
            def neighbour(s, acc):
                ar, ag, ab = acc
                r, g, b = sample(gx + ld(_P_OFFS + 2 * s),
                                 gy + ld(_P_OFFS + 2 * s + 1))
                return ar + r, ag + g, ab + b

            zero = jnp.zeros(gx.shape, f32)
            nr, ng, nb = jax.lax.fori_loop(
                1, len(_SAMPLE_OFFSETS), neighbour, (zero, zero, zero))
            # compat: the accumulation swap (kernels.py:59-60) composed with
            # the store swap leaves neighbour channels in place
            interior = ((gx >= 1.0) & (gx <= W - 2) &
                        (gy >= 1.0) & (gy <= H - 2))
            pr = jnp.where(interior, (pr + nr) / 9.0, pr)
            pg = jnp.where(interior, (pg + ng) / 9.0, pg)
            pb = jnp.where(interior, (pb + nb) / 9.0, pb)
        r_out[...] = pr
        g_out[...] = pg
        b_out[...] = pb

    return kernel


def _require_gpu(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused render kernel is compiled for a GPU, and JAX's default "
            f"backend is {jax.default_backend()!r}; use the jnp backend, or "
            "interpret=True to run the kernel in the Pallas interpreter")


def render_image_pallas(camera, scene, *, depth: int = 2, aliasing: bool = True,
                        compat: bool = True, interpret: bool = False,
                        x_offset=0.0,
                        local_width: int | None = None) -> jnp.ndarray:
    """Fused-kernel render -> float ``(w, h, 3)`` image, equal to
    :func:`..render.render_image` up to float32 reassociation.

    ``x_offset``/``local_width`` render the vertical slice ``[x_offset,
    x_offset + local_width)`` of the image; ray generation is analytic in the
    global pixel index, so a shard_map over slices reproduces the whole image
    with no halo exchange (see parallel/render_sharded.py).

    Raises ``RuntimeError`` unless JAX's default backend is a GPU or
    ``interpret=True`` asks for the Pallas interpreter.
    """
    _require_gpu(interpret)
    return _render_image_pallas(camera, scene, depth=depth, aliasing=aliasing,
                                compat=compat, interpret=interpret,
                                x_offset=x_offset, local_width=local_width)


@functools.partial(jax.jit, static_argnames=("depth", "aliasing", "compat",
                                             "interpret", "local_width"))
def _render_image_pallas(camera, scene, *, depth, aliasing, compat, interpret,
                         x_offset, local_width):
    W, H = camera.resolution
    w_out = W if local_width is None else local_width
    n_pix = w_out * H
    n_prog = pl.cdiv(n_pix, _BLOCK)
    kernel = _make_kernel(W=W, H=H, ns=scene.spheres.count,
                          npl=scene.planes.count, nl=scene.lights.count,
                          depth=depth, aliasing=aliasing, compat=compat)
    plane = jax.ShapeDtypeStruct((n_prog * _BLOCK,), jnp.float32)
    block = pl.BlockSpec((_BLOCK,), lambda i: (i,))
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_prog,),
        out_specs=(block, block, block),
        out_shape=(plane, plane, plane),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="render_pixels",
    )(_pack_table(camera, scene, compat, x_offset))
    img = jnp.stack([r[:n_pix], g[:n_pix], b[:n_pix]], axis=-1)
    return img.reshape(w_out, H, 3)


# --- differentiable fast path -----------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5))
def render_image_fast(camera, scene, depth: int = 2, aliasing: bool = True,
                      compat: bool = True, interpret: bool = False):
    """Kernel forward, XLA-autodiff backward of the jnp path."""
    return render_image_pallas(camera, scene, depth=depth, aliasing=aliasing,
                               compat=compat, interpret=interpret)


def _fwd(camera, scene, depth, aliasing, compat, interpret):
    out = render_image_pallas(camera, scene, depth=depth, aliasing=aliasing,
                              compat=compat, interpret=interpret)
    return out, (camera, scene)


def _bwd(depth, aliasing, compat, interpret, res, g):
    del interpret
    _, vjp = jax.vjp(lambda c, s: render_image(c, s, depth=depth,
                                               aliasing=aliasing, compat=compat),
                     *res)
    return vjp(g)


render_image_fast.defvjp(_fwd, _bwd)
