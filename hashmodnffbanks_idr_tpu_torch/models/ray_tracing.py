"""Masked sphere tracing + sampler + secant root finding, gradient-free.

Counterpart of ``hashmodnffbanks_idr_tpu/models/ray_tracing.py``.  Every ray
keeps a static lane and carries live/converged masks; updates are
``torch.where``-masked exactly as in the JAX package (no boolean
compaction), so a decision that compares against ``sdf_threshold`` is taken
on the same lanes by both.  The JAX ``lax.while_loop``s of the march and its
line search become the port's ``utils.graphs.while_loop``: the loop's state
is a fixed set of tensors (``MARCH_STATE``) that a body updates in place,
with the iteration counter on the device (the line search's ``k`` indexes
its backstep table, ``line_search_steps``), and its predicate
(``mask.any()``) is computed on the device: read on the host once an
iteration by the eager step, on the device by the graphed train step's
while-nodes.

The caller runs the tracer under ``torch.no_grad()``.  ``draws`` injects the
sweep's uniform draws (``sweep_draws``) so tests can feed both
implementations the same numbers; without it they come from ``generator``
through ``sweep_draws``, and a draw missing from ``draws`` raises.

Guidance (``sdf_guidance``, JAX :98-210 and :515-588): cheaper approximate
SDFs for the march's phase A (``'march'``), the sweep's coarse probes
(``'coarse'``) and the first ``prune_secant_iters`` secant iterations
(``'secant'``); every decision is taken on the exact ``sdf``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..geometry.cameras import get_sphere_intersection
from ..utils.graphs import while_loop
from ..utils.profiling import span, spanned


class RayTracerConfig(NamedTuple):
    object_bounding_sphere: float = 1.0
    sdf_threshold: float = 5.0e-5
    line_search_step: float = 0.5
    line_step_iters: int = 1
    sphere_tracing_iters: int = 10
    n_steps: int = 100
    n_secant_steps: int = 8
    hierarchical_sweep: bool = True
    prune_levels_march: int = 0
    prune_levels_coarse: int = 0
    prune_march_polish_iters: int = 3
    prune_march_tau: float = 5.0e-3
    prune_floor_interp: bool = True
    prune_secant_iters: int = 0


def sweep_stride(cfg: RayTracerConfig, guided_coarse: bool, on_cuda: bool):
    """The hierarchical sweep's coarse stride s with (n-1) % s == 0, None for
    the dense sweep (JAX :75-89).  A coarse guide that is really cheaper than
    the decision SDF flips the optimum to the smallest stride: a level-pruned
    guide anywhere, or any guide on the card (the bf16 tensor-core kernel;
    the JAX package asks the same of the TPU, :156-157)."""
    if not cfg.hierarchical_sweep:
        return None
    n = cfg.n_steps
    cands = (9, 8, 10, 7, 11, 6, 12, 5, 4, 3)
    valid = [s for s in cands if n > 2 * s and (n - 1) % s == 0]
    if not valid:
        return None
    if guided_coarse and (cfg.prune_levels_coarse > 0 or on_cuda):
        return min(valid, key=lambda s: ((n - 1) // s + 1) * 0.4 + 3 * (s - 1))
    return valid[0]


class TraceResult(NamedTuple):
    points: torch.Tensor               # (R, 3)
    network_object_mask: torch.Tensor  # (R,) bool
    dists: torch.Tensor                # (R,)


def _gather1(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """a (R, m) or (R, m, 3) at column j (R,) -> (R,) or (R, 3)."""
    if a.dim() == 2:
        return torch.gather(a, 1, j[:, None])[:, 0]
    return torch.gather(a, 1, j[:, None, None].expand(-1, 1, a.shape[-1]))[:, 0]


def sweep_draws(cfg: RayTracerConfig, guided_coarse: bool,
                generator: Optional[torch.Generator], like: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The sweep's uniform draws from ``generator`` (dtype and device of
    ``like``), in the order the sweep takes them: ``{'dense': (n,)}``, or
    ``{'coarse': (n_c,), 'fine': (n_f,)}`` for the stride that
    ``sweep_stride`` picks."""
    stride = sweep_stride(cfg, guided_coarse, like.device.type == "cuda")

    def uniform(n):
        return torch.rand(n, generator=generator, dtype=like.dtype, device=like.device)

    if stride is None:
        return {"dense": uniform(cfg.n_steps)}
    coarse = uniform((cfg.n_steps - 1) // stride + 1)
    return {"coarse": coarse, "fine": uniform(3 * (stride - 1))}


def _uniform(draws, key, n, like):
    if key not in draws:
        raise KeyError(f"draws has no {key!r} (it has {sorted(draws)})")
    u = torch.as_tensor(draws[key], dtype=like.dtype, device=like.device)
    if u.shape != (n,):
        raise ValueError(f"draws[{key!r}] has shape {tuple(u.shape)}, expected ({n},)")
    return u


def ray_trace(cfg: RayTracerConfig, sdf: Callable[[torch.Tensor], torch.Tensor],
              cam_loc: torch.Tensor, object_mask: torch.Tensor,
              ray_directions: torch.Tensor, generator: Optional[torch.Generator] = None,
              training: bool = True, sdf_guidance=None,
              draws: Optional[Dict[str, torch.Tensor]] = None) -> TraceResult:
    """Full tracer (ray_tracing.py:26-95), flattened to R = B*P rays.

    ``sdf_guidance`` ({'march', 'coarse', 'secant'}) supplies cheaper
    approximate SDFs for the guidance stages; decisions stay on ``sdf``
    (JAX :98-210)."""
    B, P, _ = ray_directions.shape
    R = B * P
    guide = sdf_guidance or {}
    sdf_march = guide.get("march")
    sdf_coarse = guide.get("coarse")
    sdf_secant = guide.get("secant") if cfg.prune_secant_iters > 0 else None

    sphere_int, mask_intersect = get_sphere_intersection(
        cam_loc, ray_directions, r=cfg.object_bounding_sphere)
    cam_flat = cam_loc[:, None, :].expand(B, P, 3).reshape(R, 3)
    dirs_flat = ray_directions.reshape(R, 3)
    near = sphere_int.reshape(R, 2)[:, 0]
    far = sphere_int.reshape(R, 2)[:, 1]
    mask_intersect = mask_intersect.reshape(R)

    (curr_start_points, unfinished_mask_start, acc_start_dis, acc_end_dis,
     min_dis, max_dis) = _sphere_tracing(cfg, sdf, cam_flat, dirs_flat,
                                         mask_intersect, near, far, sdf_march=sdf_march)

    network_object_mask = acc_start_dis < acc_end_dis

    # one fused sweep for the two disjoint ray families (JAX :136-148)
    sampler_mask = unfinished_mask_start
    n = cfg.n_steps
    min_dis_eff = torch.where(network_object_mask & ~object_mask, acc_start_dis, min_dis)
    t0 = torch.where(sampler_mask, acc_start_dis, min_dis_eff)
    t1 = torch.where(sampler_mask, acc_end_dis, max_dis)

    stride = sweep_stride(cfg, sdf_coarse is not None, cam_flat.device.type == "cuda")
    if draws is None:
        draws = sweep_draws(cfg, sdf_coarse is not None, generator, cam_flat)
    with span("sweep"):
        if stride is None:
            lin01 = torch.linspace(0.0, 1.0, n, dtype=cam_flat.dtype, device=cam_flat.device)
            rand01 = _uniform(draws, "dense", n, cam_flat)
            u = torch.where(sampler_mask[:, None], lin01[None, :], rand01[None, :])
            pts_intervals = t0[:, None] + u * (t1 - t0)[:, None]
            points = cam_flat[:, None, :] + pts_intervals[..., None] * dirs_flat[:, None, :]
            sdf_val = sdf(points.reshape(-1, 3)).reshape(R, n)
            idx_grid = torch.arange(n, dtype=torch.int64,
                                    device=cam_flat.device)[None, :].expand(R, n)
            exact_mask = None
        else:
            idx_grid, pts_intervals, points, sdf_val, exact_mask = _hierarchical_sweep(
                cfg, sdf, cam_flat, dirs_flat, sampler_mask, t0, t1, stride, draws,
                sdf_coarse=sdf_coarse)

    sampler_pts, sampler_net_obj_mask, sampler_dists = _ray_sampler(
        cfg, sdf, cam_flat, dirs_flat, object_mask, idx_grid, points, pts_intervals,
        sdf_val, sampler_mask, training, sdf_guide=sdf_secant, exact_mask=exact_mask)
    curr_start_points = torch.where(sampler_mask[:, None], sampler_pts, curr_start_points)
    acc_start_dis = torch.where(sampler_mask, sampler_dists, acc_start_dis)
    network_object_mask = torch.where(sampler_mask, sampler_net_obj_mask, network_object_mask)

    if not training:
        return TraceResult(curr_start_points, network_object_mask, acc_start_dis)

    # training-only handling of rays that miss (ray_tracing.py:71-92)
    in_mask = ~network_object_mask & object_mask & ~sampler_mask
    out_mask = ~object_mask & ~sampler_mask

    # rays that never hit the sphere: closest-to-origin point (ray_tracing.py:77-82)
    mask_left_out = (in_mask | out_mask) & ~mask_intersect
    proj_dis = -(dirs_flat * cam_flat).sum(dim=-1)
    proj_pts = cam_flat + proj_dis[:, None] * dirs_flat
    acc_start_dis = torch.where(mask_left_out, proj_dis, acc_start_dis)
    curr_start_points = torch.where(mask_left_out[:, None], proj_pts, curr_start_points)

    # rays that hit the sphere but no surface: min-SDF point of the sweep
    mask = (in_mask | out_mask) & mask_intersect
    min_idx = torch.argmin(sdf_val, dim=-1)
    curr_start_points = torch.where(mask[:, None], _gather1(points, min_idx), curr_start_points)
    acc_start_dis = torch.where(mask, _gather1(pts_intervals, min_idx), acc_start_dis)

    return TraceResult(curr_start_points, network_object_mask, acc_start_dis)


# ---------------------------------------------------------------------------
# sphere tracing (ray_tracing.py:98-187)
# ---------------------------------------------------------------------------

def _sphere_tracing(cfg, sdf, cam, dirs, mask_intersect, near, far, sdf_march=None):
    """Bidirectional march.  With a guidance SDF, phase A marches on it to a
    loose tolerance and phase B re-marches on the exact SDF (JAX :217-233)."""
    if sdf_march is not None:
        st_a = _march(cfg, sdf_march, cam, dirs, mask_intersect, near, far,
                      iters=cfg.sphere_tracing_iters, threshold=cfg.prune_march_tau)
        return _march(cfg, sdf, cam, dirs, mask_intersect, near, far,
                      iters=cfg.prune_march_polish_iters, threshold=cfg.sdf_threshold,
                      resume=(st_a[2], st_a[3]))
    return _march(cfg, sdf, cam, dirs, mask_intersect, near, far,
                  iters=cfg.sphere_tracing_iters, threshold=cfg.sdf_threshold)


def line_search_steps(cfg: RayTracerConfig, device) -> torch.Tensor:
    """The line search's backsteps ``(1 - line_search_step) / 2**k`` for
    k < ``line_step_iters``, float32 on ``device``, built there (nothing
    is copied from the host): each is the float32 that the Python step
    rounds to, since halving is exact."""
    n = cfg.line_step_iters
    halves = torch.full((n,), 0.5, dtype=torch.float32, device=device).cumprod(0) * 2.0
    return torch.full((n,), 1.0 - cfg.line_search_step, dtype=torch.float32,
                      device=device) * halves


# the march's loop-carried state, updated in place by its bodies
MARCH_STATE = ("acc_s", "acc_e", "unfin_s", "unfin_e", "curr_s", "curr_e", "next_s", "next_e",
               "not_ps", "not_pe", "curr_pts")


def _march(cfg, sdf, cam, dirs, mask_intersect, near, far, *, iters, threshold,
           resume=None):
    """JAX :236-335: an init, then the march (``iters`` at most) and, inside
    each march step, the line search (``cfg.line_step_iters`` at most), each
    a ``while_loop`` over ``MARCH_STATE`` with its predicate computed on the
    device; the line search's counter ``k`` (``st["k"]``) picks its step
    from ``line_search_steps`` on the device."""
    min_dis = torch.where(mask_intersect, near, 0.0)
    max_dis = torch.where(mask_intersect, far, 0.0)

    def sdf2(acc_s, acc_e):
        """One batched SDF call for the start+end ray families."""
        v = sdf(torch.cat([cam + acc_s[:, None] * dirs, cam + acc_e[:, None] * dirs], dim=0))
        return v[: acc_s.shape[0]], v[acc_s.shape[0]:]

    def clamp(v):
        return torch.where(v <= threshold, 0.0, v)

    # init (JAX :236-262); the state's tensors are its own, written in place
    if resume is None:
        unfin_s = unfin_e = mask_intersect
        acc_s, acc_e = min_dis.clone(), max_dis.clone()
    else:
        acc_s, acc_e = (t.clone() for t in resume)
        unfin_s = unfin_e = mask_intersect & (acc_s < acc_e)
    curr_pts = torch.where(unfin_s[:, None], cam + acc_s[:, None] * dirs, 0.0)
    s0, e0 = sdf2(acc_s, acc_e)
    curr_s = clamp(torch.where(unfin_s, s0, 0.0))
    curr_e = clamp(torch.where(unfin_e, e0, 0.0))
    st = dict(zip(MARCH_STATE, (
        acc_s, acc_e, unfin_s & (curr_s > threshold), unfin_e & (curr_e > threshold),
        curr_s, curr_e, torch.zeros_like(curr_s), torch.zeros_like(curr_e),
        torch.zeros_like(unfin_s), torch.zeros_like(unfin_e), curr_pts)))
    steps = line_search_steps(cfg, cam.device)

    def march_cond(st):
        return (st["unfin_s"] | st["unfin_e"]).any()

    def line_cond(st):
        return (st["not_ps"] | st["not_pe"]).any()

    @spanned("line_search")
    def line_body(st, _):
        """A backstep of (1 - line_search_step) / 2**k for overshoot
        (ray_tracing.py:164-183), k the loop's counter on the device."""
        step = steps.index_select(0, st["k"].reshape(1))
        not_ps, not_pe = st["not_ps"], st["not_pe"]
        st["acc_s"].copy_(torch.where(not_ps, st["acc_s"] - step * st["curr_s"], st["acc_s"]))
        st["acc_e"].copy_(torch.where(not_pe, st["acc_e"] + step * st["curr_e"], st["acc_e"]))
        sv, ev = sdf2(st["acc_s"], st["acc_e"])
        st["next_s"].copy_(torch.where(not_ps, sv, st["next_s"]))
        st["next_e"].copy_(torch.where(not_pe, ev, st["next_e"]))
        not_ps.copy_(st["next_s"] < 0)
        not_pe.copy_(st["next_e"] < 0)

    @spanned("march")
    def march_body(st, _):
        st["acc_s"].add_(st["curr_s"])
        st["acc_e"].sub_(st["curr_e"])
        sv, ev = sdf2(st["acc_s"], st["acc_e"])
        st["next_s"].copy_(torch.where(st["unfin_s"], sv, 0.0))
        st["next_e"].copy_(torch.where(st["unfin_e"], ev, 0.0))
        st["not_ps"].copy_(st["next_s"] < 0)
        st["not_pe"].copy_(st["next_e"] < 0)
        while_loop(line_cond, line_body, st, cfg.line_step_iters, "k")

        alive = st["acc_s"] < st["acc_e"]
        st["unfin_s"].logical_and_(alive)
        st["unfin_e"].logical_and_(alive)
        st["curr_s"].copy_(clamp(torch.where(st["unfin_s"], st["next_s"], 0.0)))
        st["curr_e"].copy_(clamp(torch.where(st["unfin_e"], st["next_e"], 0.0)))
        st["unfin_s"].logical_and_(st["curr_s"] > threshold)
        st["unfin_e"].logical_and_(st["curr_e"] > threshold)
        st["curr_pts"].copy_(cam + st["acc_s"][:, None] * dirs)

    while_loop(march_cond, march_body, st, iters)
    return st["curr_pts"], st["unfin_s"], st["acc_s"], st["acc_e"], min_dis, max_dis


# ---------------------------------------------------------------------------
# sweep sampler + secant (ray_tracing.py:189-268)
# ---------------------------------------------------------------------------

def _hierarchical_sweep(cfg, sdf, cam, dirs, sampler_mask, t0, t1, stride, draws,
                        sdf_coarse=None):
    """The n_steps linspace grid evaluated hierarchically (JAX :342-440):
    coarse probes every ``stride`` grid points, then the interiors of the
    first sign-flip interval and of both intervals around the coarse argmin.
    With a guidance coarse SDF, the exact fine call also re-evaluates the
    refined intervals' endpoint slots, and ``exact_mask`` marks the entries
    that sign decisions may use."""
    R = cam.shape[0]
    n = cfg.n_steps
    dev, dtype = cam.device, cam.dtype
    n_c = (n - 1) // stride + 1
    n_f = 3 * (stride - 1)

    ic = torch.arange(n_c, dtype=torch.int64, device=dev) * stride
    lin01_c = ic.to(dtype) / (n - 1)
    rand01_c = _uniform(draws, "coarse", n_c, cam)
    u_c = torch.where(sampler_mask[:, None], lin01_c[None, :], rand01_c[None, :])
    t_c = t0[:, None] + u_c * (t1 - t0)[:, None]
    pts_c = cam[:, None, :] + t_c[..., None] * dirs[:, None, :]
    v_c = (sdf_coarse or sdf)(pts_c.reshape(-1, 3)).reshape(R, n_c)

    slot = torch.arange(n_c, dtype=torch.int64, device=dev)[None, :]
    first_neg = torch.where(v_c < 0, slot.expand(R, n_c), n_c).amin(dim=-1)
    k_flip = torch.clamp(first_neg, 1, n_c - 1)
    m_slot = torch.argmin(v_c, dim=-1)
    k_min_l = torch.clamp(m_slot, 1, n_c - 1)
    k_min_r = torch.clamp(m_slot + 1, 1, n_c - 1)
    ks = torch.stack([k_flip, k_min_l, k_min_r], dim=-1)            # (R, 3)

    offs = torch.arange(1, stride, dtype=torch.int64, device=dev)
    idx_f = (((ks - 1) * stride)[..., None] + offs[None, None, :]).reshape(R, n_f)
    rand01_f = _uniform(draws, "fine", n_f, cam)
    u_f = torch.where(sampler_mask[:, None], idx_f.to(dtype) / (n - 1), rand01_f[None, :])
    t_f = t0[:, None] + u_f * (t1 - t0)[:, None]
    pts_f = cam[:, None, :] + t_f[..., None] * dirs[:, None, :]

    exact_mask = None
    if sdf_coarse is not None and sdf_coarse is not sdf:
        slots_e = torch.stack([
            k_flip - 1, k_flip,
            torch.clamp(m_slot - 1, 0, n_c - 1), m_slot,
            torch.clamp(m_slot + 1, 0, n_c - 1)], dim=-1)          # (R, 5)
        t_ends = torch.gather(t_c, 1, slots_e)
        p_ends = cam[:, None, :] + t_ends[..., None] * dirs[:, None, :]
        v_fused = sdf(torch.cat([pts_f.reshape(-1, 3), p_ends.reshape(-1, 3)], dim=0))
        v_f = v_fused[: R * n_f].reshape(R, n_f)
        v_c = v_c.scatter(1, slots_e, v_fused[R * n_f:].reshape(R, 5))
        exact_c = torch.zeros((R, n_c), dtype=torch.bool, device=dev).scatter(
            1, slots_e, torch.ones_like(slots_e, dtype=torch.bool))
        exact_mask = torch.cat([exact_c, torch.ones((R, n_f), dtype=torch.bool, device=dev)],
                               dim=1)
    else:
        v_f = sdf(pts_f.reshape(-1, 3)).reshape(R, n_f)

    idx_grid = torch.cat([ic[None, :].expand(R, n_c), idx_f], dim=1)
    return (idx_grid, torch.cat([t_c, t_f], dim=1), torch.cat([pts_c, pts_f], dim=1),
            torch.cat([v_c, v_f], dim=1), exact_mask)


def _ray_sampler(cfg, sdf, cam, dirs, object_mask, idx_grid, points, pts_intervals,
                 sdf_val, sampler_mask, training, sdf_guide=None, exact_mask=None):
    """First negative grid index, min-SDF fallback and secant refinement over
    the sweep's evaluated probes (JAX :443-512)."""
    n = cfg.n_steps
    neg = sdf_val < 0
    if exact_mask is not None:
        neg = neg & exact_mask
    gneg = torch.where(neg, idx_grid, n).amin(dim=-1)                     # (R,)
    net_surface_pts = gneg < n
    ind = torch.where(net_surface_pts, gneg, n - 1)

    def extract(g):
        """Value/t/point at the LARGEST evaluated grid index <= g."""
        cand = torch.where(idx_grid <= g[:, None], idx_grid, -1)
        j = torch.argmax(cand, dim=-1)
        return _gather1(sdf_val, j), _gather1(pts_intervals, j), _gather1(points, j)

    sdf_at_ind, t_at_ind, sampler_pts = extract(ind)
    sampler_dists = t_at_ind

    # P_out pixels: min-SDF sample (ray_tracing.py:220-226)
    p_out_mask = ~(object_mask & net_surface_pts)
    out_j = torch.argmin(sdf_val, dim=-1)
    sampler_pts = torch.where(p_out_mask[:, None], _gather1(points, out_j), sampler_pts)
    sampler_dists = torch.where(p_out_mask, _gather1(pts_intervals, out_j), sampler_dists)

    sampler_net_obj_mask = sampler_mask & net_surface_pts

    # secant (ray_tracing.py:232-247); torch's ind-1 indexing wraps at 0
    secant_pts = (net_surface_pts & object_mask) if training else net_surface_pts
    secant_pts = secant_pts & sampler_mask
    sdf_low, z_low, _ = extract((ind - 1) % n)
    with span("secant"):
        z_pred = _secant(cfg, sdf, sdf_low, sdf_at_ind, z_low, t_at_ind, cam, dirs, secant_pts,
                         sdf_guide=sdf_guide)

    sampler_pts = torch.where(secant_pts[:, None], cam + z_pred[:, None] * dirs, sampler_pts)
    sampler_dists = torch.where(secant_pts, z_pred, sampler_dists)
    return sampler_pts, sampler_net_obj_mask, sampler_dists


def _secant(cfg, sdf, sdf_low, sdf_high, z_low, z_high, cam, dirs, active, sdf_guide=None):
    """Fixed n_secant_steps masked iterations, the prediction clamped into
    the current bracket (JAX :515-588).  With ``sdf_guide``, the first
    ``prune_secant_iters`` iterations run on the guide; one exact call then
    re-validates the guided bracket (each side keeps its guided position only
    where the exact SDF confirms its sign, else reverts to its pre-guide
    endpoint), and the remaining iterations run on ``sdf``."""

    def safe_div(a, b):
        tiny = torch.where(b < 0, -1e-12, 1e-12)
        return a / torch.where(torch.abs(b) < 1e-12, tiny, b)

    def predict(z_low, sdf_low, z_high, sdf_high):
        z = -safe_div(sdf_low * (z_high - z_low), sdf_high - sdf_low) + z_low
        return torch.minimum(torch.maximum(z, torch.minimum(z_low, z_high)),
                             torch.maximum(z_low, z_high))

    def iterate(fn, iters, z_low, sdf_low, z_high, sdf_high, z_pred):
        for _ in range(iters):
            sdf_mid = torch.where(active, fn(cam + z_pred[:, None] * dirs), 0.0)
            ind_low = sdf_mid > 0
            z_low = torch.where(ind_low, z_pred, z_low)
            sdf_low = torch.where(ind_low, sdf_mid, sdf_low)
            ind_high = sdf_mid < 0
            z_high = torch.where(ind_high, z_pred, z_high)
            sdf_high = torch.where(ind_high, sdf_mid, sdf_high)
            z_pred = predict(z_low, sdf_low, z_high, sdf_high)
        return z_low, sdf_low, z_high, sdf_high, z_pred

    carry = (z_low, sdf_low, z_high, sdf_high, predict(z_low, sdf_low, z_high, sdf_high))
    m = min(cfg.prune_secant_iters, cfg.n_secant_steps) if sdf_guide is not None else 0
    if m > 0:
        z_low, sdf_low, z_high, sdf_high, _ = iterate(sdf_guide, m, *carry)
        v2 = sdf(torch.cat([cam + z_low[:, None] * dirs, cam + z_high[:, None] * dirs], dim=0))
        v2 = torch.where(torch.cat([active, active], dim=0), v2, 0.0)
        v_lo, v_hi = v2[: z_low.shape[0]], v2[z_low.shape[0]:]
        ok_lo, ok_hi = v_lo > 0, v_hi < 0
        z_low = torch.where(ok_lo, z_low, carry[0])
        sdf_low = torch.where(ok_lo, v_lo, carry[1])
        z_high = torch.where(ok_hi, z_high, carry[2])
        sdf_high = torch.where(ok_hi, v_hi, carry[3])
        carry = (z_low, sdf_low, z_high, sdf_high, predict(z_low, sdf_low, z_high, sdf_high))
    return iterate(sdf, cfg.n_secant_steps - m, *carry)[-1]
