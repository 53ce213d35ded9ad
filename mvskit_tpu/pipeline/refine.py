"""Batched patch refinement.

The reference refines one patch at a time with derivative-free BOBYQA
over 3 parameters (depth-along-ray, two normal angles; reference
pmmvps/optim.cpp:470-599, <=500 cost evaluations through a non-reentrant
static-singleton trampoline). That shape is hostile to a wide data-
parallel accelerator, so the
refinement is re-expressed as *batched random hypothesis search* with a
geometrically shrinking trust region — the standard GPU PatchMatch-MVS
scheme — over the *same* encoding (optim.cpp:549-599) and the *same*
robust-INCC objective (cost_func, optim.cpp:401-468), with the same
angle bounds (+-23.99999 * ascale, ascale = pi/48). Thousands of
patches refine concurrently; candidate evaluation is one fused NCC
batch per round.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.patches import count_valid
from ..geometry import camera as cam
from ..image.scene import Scene
from ..ops import ncc as nccops

ANGLE_BOUND = 23.99999  # reference optim.cpp:496-497


def encode_normal(scene: Scene, ref, normal):
    """Normal -> two camera-frame angles (reference optim.cpp:553-580).

    Returns (angle1, angle2) in radians (NOT divided by ascale)."""
    n3 = normal[..., :3]
    fx = jnp.sum(scene.cams.xaxis[ref] * n3, axis=-1)
    fy = jnp.sum(scene.cams.yaxis[ref] * n3, axis=-1)
    fz = jnp.sum(scene.cams.zaxis[ref] * n3, axis=-1)
    a2 = jnp.arcsin(jnp.clip(fy, -1.0, 1.0))
    cosb = jnp.cos(a2)
    safe = jnp.where(cosb == 0.0, 1.0, cosb)
    sina = fx / safe
    cosa = -fz / safe
    a1 = jnp.arccos(jnp.clip(cosa, -1.0, 1.0))
    a1 = jnp.where(sina < 0.0, -a1, a1)
    a1 = jnp.where(cosb == 0.0, 0.0, a1)
    return a1, a2


def decode_normal(scene: Scene, ref, angle1, angle2):
    """Two camera-frame angles -> world normal (optim.cpp:582-595)."""
    fx = jnp.sin(angle1) * jnp.cos(angle2)
    fy = jnp.sin(angle2)
    fz = -jnp.cos(angle1) * jnp.cos(angle2)
    n3 = (
        scene.cams.xaxis[ref] * fx[..., None]
        + scene.cams.yaxis[ref] * fy[..., None]
        + scene.cams.zaxis[ref] * fz[..., None]
    )
    return jnp.concatenate([n3, jnp.zeros_like(n3[..., :1])], axis=-1)


def decode_coord(center, ray, dscale, v0):
    """depth parameter -> coordinate (optim.cpp:597-599)."""
    return center + (dscale * v0)[..., None] * ray


class RefineResult(NamedTuple):
    coord: jnp.ndarray    # [B, 4]
    normal: jnp.ndarray   # [B, 4]
    ncc: jnp.ndarray      # [B] final weighted ncc (1 - unrobustincc)
    cost: jnp.ndarray     # [B] final cost_func value


def _eval_cost(
    scene, views, coord, normal, minimum, level, wsize, angle_threshold1,
    luma=False, n_illums=1,
):
    """cost_func (reference optim.cpp:401-468); with n_illums > 1 the
    robust-INCC cost averages over the illumination axis (the live
    wiring of the reference's dormant multi-illum getTex,
    optim.cpp:846-893)."""
    costs = []
    for il in range(max(n_illums, 1)):
        tex, valid = nccops.texs_for_views(
            scene, views, coord, normal, level, wsize, angle_threshold1,
            illum=il, luma=luma,
        )
        costs.append(nccops.incc_cost(tex, valid, minimum))
    return sum(costs) / len(costs)


def refine_batch(
    scene: Scene,
    coord,
    normal,
    images,
    dscale,
    key,
    *,
    level: int,
    wsize: int,
    tau: int,
    min_image_num: int,
    angle_threshold1: float,
    ascale: float,
    rounds: int,
    n_cands: int,
    shrink: float,
    init_depth_radius: float,
    init_angle_radius: float,
    grad_steps: int = 0,
    grad_lr: float = 0.5,
    luma: bool = False,
    n_illums: int = 1,
    rgb_tail: int = 0,
) -> RefineResult:
    """Refine a batch of patches (reference Optim::refinePatch,
    optim.cpp:470-547). `images` is the fixed view list for the whole
    refinement (the reference snapshots m_indexes); entry 0 is the
    reference view. Total cost evaluations per patch:
    rounds * n_cands (budget analog of the reference's maxeval; the
    starting pose scores as round 0's pinned candidate 0 instead of a
    separate ungrouped pass).

    Every candidate is scored with exactly the reference's
    per-evaluation semantics (cost_func, optim.cpp:401-468).

    rgb_tail (only with luma=True): the LAST rgb_tail rounds search in
    RGB instead of luminance. The coarse rounds only need to locate the
    NCC basin, where the cheap luminance signal suffices; the final
    rounds set the sub-pixel accuracy, where chroma contrast matters."""
    B = coord.shape[0]
    ref = jnp.maximum(images[:, 0], 0)
    center = coord
    ray = center - scene.cams.center[ref]
    ray = ray / jnp.sqrt(
        jnp.maximum(jnp.sum(ray * ray, axis=-1, keepdims=True), 1e-20)
    )
    views = images[:, :tau]
    nimg = count_valid(images)
    sz = jnp.minimum(tau, nimg)
    minimum = jnp.minimum(min_image_num, sz)
    safe_dscale = jnp.where(dscale == 0.0, 1.0, dscale)

    # weights frozen at the starting coordinate (reference optim.cpp:490)
    weights = nccops.compute_weights(scene, views, coord, normal, level)

    a1, a2 = encode_normal(scene, ref, normal)
    p0 = jnp.stack(
        [jnp.zeros((B,)), a1 / ascale, a2 / ascale], axis=-1
    )
    p0 = p0.at[:, 1:].set(jnp.clip(p0[:, 1:], -ANGLE_BOUND, ANGLE_BOUND))

    def cost_of(p):
        c = decode_coord(center, ray, safe_dscale, p[:, 0])
        n = decode_normal(scene, ref, p[:, 1] * ascale, p[:, 2] * ascale)
        return _eval_cost(
            scene, views, c, n, minimum, level, wsize, angle_threshold1,
            luma=luma, n_illums=n_illums,
        )

    # The starting pose p0 is NOT evaluated in a separate pass: round 0
    # pins candidate 0's jitter to zero, so p0 scores inside the first
    # candidate batch and best_c starts at +inf. The total budget is
    # rounds * n_cands evaluations (the analog of the reference's
    # maxeval, optim.cpp:487).
    best_p = p0
    best_c = jnp.full((B,), jnp.inf, jnp.float32)

    radius0 = jnp.asarray(
        [init_depth_radius, init_angle_radius, init_angle_radius],
        jnp.float32,
    )

    def make_round_body(luma_mode: bool):
        def round_body(carry, xs):
            rkey, is_first = xs
            best_p, best_c, radius = carry
            delta = (
                jax.random.uniform(
                    rkey, (B, n_cands, 3), minval=-1.0, maxval=1.0
                )
                * radius
            )
            # round 0: candidate 0 is the unperturbed starting pose
            delta = jnp.where(
                is_first, delta.at[:, 0, :].set(0.0), delta
            )
            cand = best_p[:, None, :] + delta
            cand = cand.at[:, :, 1:].set(
                jnp.clip(cand[:, :, 1:], -ANGLE_BOUND, ANGLE_BOUND)
            )
            flat = cand.reshape(B * n_cands, 3)
            # evaluation needs per-candidate patch identity: tile
            # row-wise
            c = decode_coord(
                jnp.repeat(center, n_cands, axis=0),
                jnp.repeat(ray, n_cands, axis=0),
                jnp.repeat(safe_dscale, n_cands, axis=0),
                flat[:, 0],
            )
            n = decode_normal(
                scene,
                jnp.repeat(ref, n_cands, axis=0),
                flat[:, 1] * ascale,
                flat[:, 2] * ascale,
            )
            costs = _eval_cost(
                scene,
                jnp.repeat(views, n_cands, axis=0),
                c,
                n,
                jnp.repeat(minimum, n_cands),
                level,
                wsize,
                angle_threshold1,
                luma=luma_mode,
                n_illums=n_illums,
            ).reshape(B, n_cands)
            kbest = jnp.argmin(costs, axis=1)
            cbest = jnp.take_along_axis(
                costs, kbest[:, None], axis=1
            )[:, 0]
            pbest = jnp.take_along_axis(
                cand, kbest[:, None, None], axis=1
            )[:, 0]
            improved = cbest < best_c
            best_p = jnp.where(improved[:, None], pbest, best_p)
            best_c = jnp.where(improved, cbest, best_c)
            return (best_p, best_c, radius * shrink), None

        return round_body

    if rounds > 0:
        # two scan segments: coarse rounds in the requested mode, the
        # last rgb_tail rounds always RGB (no-op unless luma=True).
        # Luma and RGB costs sit on slightly different scales, so the
        # tail re-anchors instead of comparing across modes: best_c
        # resets to +inf and the first RGB round pins candidate 0 to
        # the incumbent pose — its RGB cost enters the same argmin as
        # the jittered candidates, exactly like the round-0 start fold.
        tail = min(rgb_tail, rounds) if luma else 0
        n1 = rounds - tail
        keys = jax.random.split(key, rounds)
        carry = (best_p, best_c, radius0)
        if n1 > 0:
            first = jnp.arange(n1) == 0
            carry, _ = lax.scan(
                make_round_body(luma), carry, (keys[:n1], first)
            )
        if tail > 0:
            bp, bc, rad = carry
            if n1 > 0:
                bc = jnp.full_like(bc, jnp.inf)
            carry = (bp, bc, rad)
            first = jnp.arange(tail) == 0
            carry, _ = lax.scan(
                make_round_body(False), carry, (keys[n1:], first)
            )
        best_p, best_c, _ = carry
    else:  # degenerate budget: score the start pose only
        best_c = cost_of(p0)

    # optional gradient polish: the NCC objective is differentiable in
    # the 3 encoded parameters through the bilinear warp (a capability
    # the reference's derivative-free BOBYQA cannot use); safeguarded
    # accept-if-better steps so the polish can only improve the cost
    if grad_steps > 0:
        grad_fn = jax.grad(lambda p: jnp.sum(cost_of(p)))
        for _ in range(grad_steps):
            g = grad_fn(best_p)
            gn = jnp.sqrt(jnp.maximum(jnp.sum(g * g, axis=-1, keepdims=True), 1e-12))
            cand = best_p - grad_lr * g / gn
            cand = cand.at[:, 1:].set(
                jnp.clip(cand[:, 1:], -ANGLE_BOUND, ANGLE_BOUND)
            )
            c = cost_of(cand)
            improved = c < best_c
            best_p = jnp.where(improved[:, None], cand, best_p)
            best_c = jnp.where(improved, c, best_c)

    out_coord = decode_coord(center, ray, safe_dscale, best_p[:, 0])
    out_normal = decode_normal(
        scene, ref, best_p[:, 1] * ascale, best_p[:, 2] * ascale
    )
    # final score: weighted robust INCC at the refined pose with the
    # frozen weights (reference optim.cpp:539), RGB always, averaged
    # over illuminations when multi-illum is wired through
    scores = []
    for il in range(max(n_illums, 1)):
        tex, valid = nccops.texs_for_views(
            scene, views, out_coord, out_normal, level, wsize,
            angle_threshold1, illum=il,
        )
        s = nccops.incc_weighted(tex, valid, weights, robust=True)
        scores.append(jnp.where(nimg < 2, 2.0, s))
    score = sum(scores) / len(scores)
    out_ncc = 1.0 - nccops.unrobustincc(score)
    return RefineResult(out_coord, out_normal, out_ncc, best_c)
