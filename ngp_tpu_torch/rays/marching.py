"""Occupancy-grid ray marching and compositing for the renderer and the
trainer (port of ``ngp_tpu/rays/marching.py``).

Cone stepping t_{k+1} = t_k + clamp(t_k·c, Δm, ΔM) has an exact 3-phase
closed form, so samples come from a lattice evaluation + occupancy
filter + compaction.
"""
from __future__ import annotations

from typing import Optional

import torch

from ngp_tpu_torch.common import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from ngp_tpu_torch.grid import occupancy as occ
from ngp_tpu_torch.rays.camera import ray_aabb_intersect


def calc_dt(t, cone_angle):
    return torch.clamp(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)


def cone_angle_for(aabb_scale: int) -> float:
    """ref: src/testbed_nerf.cu:2730 — 1/256 for aabb_scale > 1, else 0."""
    return 1.0 / 256.0 if aabb_scale > 1 else 0.0


def step_lattice_at(t0: torch.Tensor, k: torch.Tensor,
                    cone_angle: float) -> torch.Tensor:
    """Closed form of the k-th cone step from t0 at any step indices k
    (broadcast-compatible shapes):
      linear  (t < Δm/c):  t_k = t0 + k·Δm
      geometric:           t_k = t_end_p1 · (1+c)^(k-n1)
      linear  (t ≥ ΔM/c):  t_k = t_end_p2 + (k-n1-n2)·ΔM
    cone_angle == 0 → uniform Δm lattice."""
    k = k.to(torch.float32)
    dm, dM = MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE
    if cone_angle <= 0.0:
        return t0 + k * dm
    c = cone_angle
    ta, tb = dm / c, dM / c
    n1 = torch.ceil(torch.clamp(ta - t0, min=0.0) / dm)
    t_p1end = t0 + n1 * dm
    # f32 like the JAX package, which evaluates log1p(c) on weak-typed f32;
    # filled on the device (a host tensor copied to the card waits for it)
    ratio = torch.log1p(torch.full((), c, dtype=torch.float32,
                                   device=t0.device))
    n2 = torch.ceil(torch.clamp(torch.log(torch.clamp(
        tb / torch.clamp(t_p1end, min=1e-10), min=1.0)), min=0.0) / ratio)
    t_p2end = t_p1end * torch.exp(n2 * ratio)
    in1 = k < n1
    in2 = (~in1) & (k < n1 + n2)
    t_lin = t0 + k * dm
    t_geo = t_p1end * torch.exp((k - n1) * ratio)
    t_top = t_p2end + (k - n1 - n2) * dM
    return torch.where(in1, t_lin, torch.where(in2, t_geo, t_top))


def step_lattice(t0: torch.Tensor, cone_angle: float,
                 n_steps: int) -> torch.Tensor:
    """(R,) → (R, K) sample times (see step_lattice_at)."""
    k = torch.arange(n_steps, dtype=torch.float32, device=t0.device)[None, :]
    return step_lattice_at(t0[:, None], k, cone_angle)


def march_rays(bitfield, o, d, jitter: Optional[torch.Tensor],
               n_rays: int, march_steps: int, cone_angle: float,
               max_cascade: int, aabb_min, aabb_size,
               t_start_min: float = 0.0):
    """Lattice sample generation. Returns (t, dt, emit), each (R, K).
    ``jitter`` (R,) in [0,1) offsets the start of each ray by up to one
    step; None starts at the AABB entry."""
    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = torch.clamp(tmin, min=t_start_min)
    if jitter is not None:
        t0 = tmin + calc_dt(tmin, cone_angle) * jitter
    else:
        t0 = tmin
    t = step_lattice(t0, cone_angle, march_steps)          # (R, K)
    dt = calc_dt(t, cone_angle)
    pos = o[:, None, :] + t[..., None] * d[:, None, :]
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]
    flat_pos = pos.reshape(-1, 3)
    mip = occ.mip_from_dt(dt.reshape(-1), flat_pos, max_cascade)
    occd = occ.occupied_at(bitfield, flat_pos, mip).reshape(n_rays, -1)
    return t, dt, inside & occd


def merge_excess_samples(emit, dt, cap: int):
    """Per-ray decimation with dt compensation on an (R, K) lattice window:
    a ray with more than ``cap`` active samples keeps every m-th
    (m = ceil(count/cap)), and each kept sample's dt is scaled by the size
    of the group it stands for, so optical depth is preserved rather than
    truncated. Returns (keep_mask, dt_effective)."""
    e = emit.to(torch.int32)
    c = e.sum(dim=1, keepdim=True)                             # (R, 1)
    m = torch.clamp(-torch.div(-c, cap, rounding_mode="floor"), min=1)
    rank = torch.cumsum(e, dim=1) - 1                          # 0-indexed
    keep = emit & (torch.remainder(rank, m) == 0)
    group = torch.minimum(m, c - rank).to(dt.dtype)            # ≥1 at kept
    return keep, torch.where(keep, dt * group, dt)


def compact_samples(t, dt, emit):
    """(R, K) lattice → ray-major sample stream, sized by the live count.

    The JAX package compacts into a static capacity with a sentinel ray id;
    here the stream has exactly the emitted samples, in the same order
    (ray by ray, lattice slot ascending), so every ray fits. Returns
    (t, dt, ray_id, counts, offsets, k_idx) where k_idx is each sample's
    lattice slot, which ``exclusive_depth`` needs."""
    counts = emit.sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    s_ray, s_k = emit.nonzero(as_tuple=True)
    return t[s_ray, s_k], dt[s_ray, s_k], s_ray, counts, offsets, s_k


def merged_count(live: torch.Tensor, cap) -> torch.Tensor:
    """The samples ``merge_excess_samples`` keeps of a ray with ``live``
    active samples under ``cap`` (integers, broadcast): ceil(c / m) with
    m = max(ceil(c / cap), 1), 0 for c = 0."""
    m = torch.clamp(-torch.div(-live, cap, rounding_mode="floor"), min=1)
    return -torch.div(-live, m, rounding_mode="floor")


def exclusive_depth(sdt, s_ray, s_k, n_rays: int, n_k: int):
    """Per-sample EXCLUSIVE per-ray optical-depth prefix, computed on the
    (R, K) lattice (scatter → cumsum along K → gather). One global stream
    cumsum loses the small per-ray prefixes to f32 quantization once σ
    sharpens (in the JAX package it made training diverge)."""
    lat = torch.zeros((n_rays, n_k), dtype=sdt.dtype, device=sdt.device)
    lat.index_put_((s_ray, s_k), sdt, accumulate=True)
    excl = torch.cumsum(lat, dim=1) - lat
    return excl[s_ray, s_k]


def ray_sums(values, s_ray, s_k, n_rays: int, n_k: int):
    """Per-ray sums of a sample stream's ``values`` (S, ...) in a fixed
    order: each sample is written to its own (ray, lattice slot) cell, and
    each ray's row of the lattice is reduced. A scatter-add
    (``index_add_``) sums in no fixed order on the card, so two renders of
    one frame could differ in their last bits."""
    lat = values.new_zeros((n_rays, n_k) + tuple(values.shape[1:]))
    lat[s_ray, s_k] = values
    return lat.sum(1)


def composite_samples(sigma, rgb, s_dt, s_ray, s_k, n_rays: int, n_k: int):
    """Segmented volumetric compositing on a compacted sample stream, with
    per-ray transmittance from the lattice cumsum (``exclusive_depth``) and
    per-ray sums in a fixed order (``ray_sums``): the same inputs give the
    same bits. Returns (rgb_ray (R,3), opacity (R,), weights (S,))."""
    sdt = sigma * s_dt
    excl_ray = exclusive_depth(sdt, s_ray, s_k, n_rays, n_k)
    T = torch.exp(-torch.clamp(excl_ray, 0.0, 88.0))
    w = T * (1.0 - torch.exp(-sdt))
    rgb_ray = ray_sums(w[:, None] * rgb, s_ray, s_k, n_rays, n_k)
    opt_depth = ray_sums(torch.clamp(sdt, max=88.0), s_ray, s_k, n_rays, n_k)
    return rgb_ray, 1.0 - torch.exp(-opt_depth), w


def _cap_prefix(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """Which units keep their items when the stream holds ``cap``: a
    prefix, ending before the first unit that does not fit whole."""
    return torch.cumsum(counts, 0) <= cap


def march_and_compact(bitfield, o, d, jitter, n_rays: int, march_steps: int,
                      cone_angle: float, max_cascade: int, aabb_min,
                      aabb_size, capacity: int, ray_mask=None):
    """The flat training march: every lattice sample gets the bitfield
    test, and the stream holds ``capacity`` samples, dropping WHOLE RAYS
    past it (the JAX package's ``compact_samples``). Returns what
    ``march_and_compact_hier`` returns, with a segment total of 0."""
    t, dt, emit = march_rays(bitfield, o, d, jitter, n_rays, march_steps,
                             cone_angle, max_cascade, aabb_min, aabb_size)
    if ray_mask is not None:
        emit = emit & ray_mask[:, None]
    counts = emit.sum(1)
    total = int(counts.sum())
    emit = emit & _cap_prefix(counts, capacity)[:, None]
    s_t, s_dt, s_ray, counts, _, s_k = compact_samples(t, dt, emit)
    return s_t, s_dt, s_ray, counts, total, 0, s_k


def _hier_coarse(coarse, o, d, jitter, n_rays: int, march_steps: int,
                 cone_angle: float, max_cascade: int, aabb_min, aabb_size,
                 seg: int, t_start_min: float, ray_mask=None):
    """Level 1 of the hierarchical march on the (R, K) lattice: the
    lattice (t, dt), which of its samples lie inside the AABB (and on a
    ray of ``ray_mask``), and each ``seg``-step segment's coarse test at
    its midpoint, (R, K/seg)."""
    K = march_steps
    if K % seg:
        raise ValueError(f"march_steps {K} is not a multiple of {seg}")
    n_seg = K // seg
    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = torch.clamp(tmin, min=t_start_min)
    t0 = tmin if jitter is None else tmin + calc_dt(tmin, cone_angle) * jitter
    t = step_lattice(t0, cone_angle, K)                    # (R, K)
    dt = calc_dt(t, cone_angle)
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]
    if ray_mask is not None:
        inside = inside & ray_mask[:, None]
    tm = t.view(n_rays, n_seg, seg)[:, :, seg // 2]
    dm = dt.view(n_rays, n_seg, seg)[:, :, seg // 2]
    pos_m = (o[:, None, :] + tm[..., None] * d[:, None, :]).reshape(-1, 3)
    mip_m = occ.mip_from_dt(dm.reshape(-1), pos_m, max_cascade)
    emit_seg = occ.coarse_occupied_at(coarse, pos_m, mip_m).view(
        n_rays, n_seg) & inside.view(n_rays, n_seg, seg).any(-1)
    return t, dt, inside, emit_seg


def _hier_fine(bitfield, o, d, t, dt, inside, ray, seg_k, seg: int,
               max_cascade: int):
    """The fine bitfield test on the ``seg`` samples of each segment
    (``ray``, ``seg_k``) of the lattice. Returns (lattice columns, t, dt,
    live mask), each (S1, seg)."""
    ks = seg_k[:, None] * seg + torch.arange(seg, device=o.device)[None]
    t_s = t[ray[:, None], ks]
    dt_s = dt[ray[:, None], ks]
    pos_s = (o[ray][:, None, :] + t_s[..., None]
             * d[ray][:, None, :]).reshape(-1, 3)
    mip_s = occ.mip_from_dt(dt_s.reshape(-1), pos_s, max_cascade)
    return ks, t_s, dt_s, inside[ray[:, None], ks] & occ.occupied_at(
        bitfield, pos_s, mip_s).view(t_s.shape)


def march_and_compact_hier(bitfield, coarse, o, d, jitter, n_rays: int,
                           march_steps: int, cone_angle: float,
                           max_cascade: int, aabb_min, aabb_size,
                           capacity: int, seg: int = 8,
                           t_start_min: float = 0.0, ray_mask=None):
    """The training march, in two levels: segments of ``seg`` lattice
    steps are culled with the conservative 16³ coarse mask (one lookup per
    segment midpoint), and only the samples of surviving segments get the
    fine bitfield test.

    Capacity semantics of the JAX package: the segment stream holds
    ``capacity // seg * 4`` segments and drops WHOLE RAYS past it; the
    sample stream holds ``capacity`` samples and drops WHOLE SEGMENTS past
    it (so a ray at the boundary may keep only its front segments). The
    streams hold exactly the kept items, ray-major and front to back, in
    the JAX package's order. ``jitter`` (R,) in [0,1) offsets each ray's
    start by up to one step; None starts at the AABB entry.

    Returns (s_t, s_dt, s_ray, counts, total, seg_total, s_k): per-sample
    time, step, ray id and lattice slot; per-ray kept counts; the sample
    total of the kept segments before the sample cap, and the
    surviving-segment total before the segment cap, which the trainer
    adapts its live ray count from."""
    t, dt, inside, emit_seg = _hier_coarse(
        coarse, o, d, jitter, n_rays, march_steps, cone_angle, max_cascade,
        aabb_min, aabb_size, seg, t_start_min, ray_mask)
    seg_counts = emit_seg.sum(1)
    seg_total = int(seg_counts.sum())
    emit_seg = emit_seg & _cap_prefix(seg_counts,
                                      capacity // seg * 4)[:, None]
    seg_ray, seg_k = emit_seg.nonzero(as_tuple=True)
    ks, t_s, dt_s, emit_fine = _hier_fine(bitfield, o, d, t, dt, inside,
                                          seg_ray, seg_k, seg, max_cascade)

    # level 2: the sample stream, whole segments dropped past the cap
    fine_counts = emit_fine.sum(1)
    total = int(fine_counts.sum())
    emit_fine = emit_fine & _cap_prefix(fine_counts, capacity)[:, None]
    s_seg, s_within = emit_fine.nonzero(as_tuple=True)
    s_ray = seg_ray[s_seg]
    counts = torch.bincount(s_ray, minlength=n_rays)
    return (t_s[s_seg, s_within], dt_s[s_seg, s_within], s_ray, counts,
            total, seg_total, seg_k[s_seg] * seg + s_within)


# --- the wave renderers' marches ---------------------------------------------

def stream_slots(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """Ray-major compaction of a (R, K) mask into ``capacity`` slots with
    no host sync: each slot's flat index r·K + k into the mask, in the
    order ``compact_samples`` emits them, and R·K in the slots past the
    kept items. Whole rows that do not fit are dropped, as the JAX
    package's ``compact_samples`` drops whole rays past its capacity. A
    caller that knows the live count passes it and keeps every item."""
    R, K = mask.shape
    fits = torch.cumsum(mask.sum(1), 0) <= capacity
    flat = (mask & fits[:, None]).reshape(-1)
    dst = torch.where(flat, torch.cumsum(flat, 0) - 1, capacity)
    slots = torch.full((capacity + 1,), R * K, dtype=torch.int64,
                       device=mask.device)
    # every kept item has a slot of its own; the rest land on the spare one
    slots.scatter_(0, dst, torch.arange(R * K, device=mask.device))
    return slots[:capacity]


def march_rays_hier(bitfield, coarse, o, d, jitter: Optional[torch.Tensor],
                    n_rays: int, march_steps: int, cone_angle: float,
                    max_cascade: int, aabb_min, aabb_size,
                    t_start_min: float = 0.0, seg: int = 8,
                    seg_capacity: int = 0):
    """``march_rays`` with the two-level occupancy filter of
    ``march_and_compact_hier``, and the lattice layout out: (t, dt, emit)
    each (R, K), plus the surviving-segment total (a device scalar).

    Segments of ``seg`` steps are culled at their midpoints on the
    conservative coarse mask, the survivors go into a stream of
    ``seg_capacity`` segments (R·K/seg/8 when 0; whole rays past it are
    dropped, as in the JAX package, so the caller compares the total with
    the capacity), and only their samples get the fine bitfield test. The
    emit mask equals ``march_rays``' wherever nothing was dropped: the
    coarse mask never culls a sample the fine test keeps. No host sync."""
    t, dt, inside, emit_seg = _hier_coarse(
        coarse, o, d, jitter, n_rays, march_steps, cone_angle, max_cascade,
        aabb_min, aabb_size, seg, t_start_min)
    n_seg = march_steps // seg
    slots = stream_slots(emit_seg, seg_capacity or (n_rays * n_seg // 8))
    ray = slots // n_seg                      # n_rays past the kept segments
    ks, _, _, emit_s = _hier_fine(
        bitfield, o, d, t, dt, inside, torch.clamp(ray, max=n_rays - 1),
        slots % n_seg, seg, max_cascade)
    # back onto the lattice; the empty slots write to a spare row
    emit = torch.zeros((n_rays + 1, march_steps), dtype=torch.bool,
                       device=o.device)
    emit[ray[:, None], ks] = emit_s
    return t, dt, emit[:n_rays], emit_seg.sum()


def coarse_segments(coarse, o, d, n_rays: int, march_steps: int,
                    cone_angle: float, max_cascade: int, aabb_min, aabb_size,
                    seg: int = 8, t_start_min: float = 0.0):
    """Level 1 of ``march_segment_stream``: each ray's K/seg segment
    midpoints, in closed form, against the 16³ conservative coarse mask.
    Returns (t0, tmax, emit_seg (R, K/seg)); a segment is inside iff its
    first sample is (t rises)."""
    K = march_steps
    if K % seg:
        raise ValueError(f"march_steps {K} is not a multiple of {seg}")
    n_seg = K // seg
    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    t0 = torch.clamp(tmin, min=t_start_min)
    kf = torch.arange(n_seg, dtype=torch.int32, device=o.device)[None, :]
    tm = step_lattice_at(t0[:, None], kf * seg + seg // 2, cone_angle)
    dm = calc_dt(tm, cone_angle)
    pos_m = (o[:, None, :] + tm[..., None] * d[:, None, :]).reshape(-1, 3)
    mip_m = occ.mip_from_dt(dm.reshape(-1), pos_m, max_cascade)
    occ_seg = occ.coarse_occupied_at(coarse, pos_m, mip_m).view(n_rays, n_seg)
    t_first = step_lattice_at(t0[:, None], kf * seg, cone_angle)
    inside_seg = (t_first < tmax[:, None]) & (tmax > t0)[:, None]
    return t0, tmax, occ_seg & inside_seg


def march_segment_stream(bitfield, coarse, o, d, n_rays: int,
                         march_steps: int, cone_angle: float,
                         max_cascade: int, aabb_min, aabb_size,
                         seg_capacity: int, seg: int = 8,
                         t_start_min: float = 0.0, segments=None):
    """Two-level march straight to a compacted SEGMENT stream, with no
    (R, K) lattice (the device-dispatch wave renderer's march).

    Level 1 (``coarse_segments``, or its result passed as ``segments``:
    the renderer takes every chunk's count in one host sync) culls
    segments on the coarse mask; the survivors go into a stream of
    ``seg_capacity`` (ray, segment) pairs, whole rays past it dropped as in
    the JAX package. Level 2 re-derives each surviving segment's ``seg``
    sample times in closed form from (t0[ray], step index), bit-identical
    to ``step_lattice``, and runs the fine bitfield test on them only.

    Returns (t0, tmax, seg_ray, seg_k, t_s, dt_s, emit_s, seg_total):
      t0/tmax      (R,)        per-ray first sample time / AABB exit
      seg_ray      (S1,)       ray id per stream slot (n_rays past the kept)
      seg_k        (S1,)       segment index per slot
      t_s/dt_s     (S1, seg)   sample times / base step sizes
      emit_s       (S1, seg)   live-sample mask (fine occupancy ∧ inside)
      seg_total    ()          surviving segments before the capacity"""
    n_seg = march_steps // seg
    t0, tmax, emit_seg = segments or coarse_segments(
        coarse, o, d, n_rays, march_steps, cone_angle, max_cascade,
        aabb_min, aabb_size, seg, t_start_min)
    slots = stream_slots(emit_seg, seg_capacity)
    seg_ray = slots // n_seg
    seg_k = slots % n_seg
    rid0 = torch.clamp(seg_ray, max=n_rays - 1)
    ks = seg_k[:, None] * seg + torch.arange(seg, dtype=torch.int64,
                                             device=o.device)
    t_s = step_lattice_at(t0[rid0][:, None], ks, cone_angle)
    dt_s = calc_dt(t_s, cone_angle)
    pos_s = (o[rid0][:, None, :] + t_s[..., None]
             * d[rid0][:, None, :]).reshape(-1, 3)
    mip_s = occ.mip_from_dt(dt_s.reshape(-1), pos_s, max_cascade)
    emit_s = occ.occupied_at(bitfield, pos_s, mip_s).view(t_s.shape) \
        & (t_s < tmax[rid0][:, None]) & (seg_ray < n_rays)[:, None]
    return t0, tmax, seg_ray, seg_k, t_s, dt_s, emit_s, emit_seg.sum()
