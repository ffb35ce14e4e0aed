"""Explicit halo-exchange sharding over `torch.distributed`.

Strategy B of the JAX package (its parallel/halo.py): shard the frame's
row axis across the ranks of a mesh and exchange exactly the stencil
halos each stage needs.  Every rank runs the port's kernels on its
shard: B1 in its halo-shard mode, then the pipeline's stage functions
of cfg.engine (`models.pipeline`: `stereo_core`, `bilateral`, `feather`,
`intermediate_views`) with B7's labels, B8/B9 a round at a time, B7's
hits and B11 between them; on the band engine the views are B12's view
stack, every view in one launch.

Halo widths (those of the JAX package, each checked against the stage's
stencil):
  image           3*usd        arms need +-usd of every cost row; cost /
                               pass-1 rows +-2*usd feed the two V passes
                               (the census' +-3 fits inside for usd >= 3)
  IRV per round   usd          the histogram's vertical span, exchanged
                               again every round
  bilateral       radius
  bleed           radius       (with the reference's quirky edge rule)
  feather         radius       (clamp)
  interlace       0            row-local, with the global row's phase;
                                a resampled output exchanges the few view
                                rows its lerps reach

Global borders: a rank at the frame's edge fills its missing halo per
edge mode (clamp replication, zeros, the bleed mirror quirk), so every
stage sees the borders the unsharded op computes.

Like the JAX package's sharded paths, this one has no median stage:
`use_median` is not read (the JAX halo frame then differs from its
`process_frame`; parallel.sharded, the XLA partitioner's strategy, does
run it).
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_to_multiview_tpu_torch.config import PipelineConfig
from stereo_to_multiview_tpu_torch.models.pipeline import (
    bilateral, check_ported, feather, intermediate_views, resolve_device,
    stereo_core)
from stereo_to_multiview_tpu_torch.ops.cross import cross_arms_lr
from stereo_to_multiview_tpu_torch.ops.dcc import dr_dcc
from stereo_to_multiview_tpu_torch.ops.demux import demux_sbs
from stereo_to_multiview_tpu_torch.ops.dibr import (
    dibr_backward_warp_dyn, dibr_bleed_mask, dibr_occl, synth_shifts)
from stereo_to_multiview_tpu_torch.ops.filters import filter_median
from stereo_to_multiview_tpu_torch.ops.irv import irv_round
from stereo_to_multiview_tpu_torch.ops.mux import (
    mux_merge_ab, mux_multiview_rows, mux_view_pattern)
from stereo_to_multiview_tpu_torch.ops.scale import (
    lerp_axis, lerp_gather, lerp_taps)
from stereo_to_multiview_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce_sum)

F32, U8 = torch.float32, torch.uint8
EDGES = ("clamp", "zero", "bleed")


def _edge_fill(x: torch.Tensor, n: int, top: bool, edge: str):
    """The n rows an outermost shard's missing halo gets: above its first
    row (top) or below its last."""
    if edge == "zero":
        return x.new_zeros((n, *x.shape[1:]))
    if edge == "clamp":
        row = x[:1] if top else x[-1:]
        return row.expand(n, *x.shape[1:])
    # the bleed rule: rows -n..-1 mirror rows n..1; rows h..h+n-1 read
    # row h-1-off, off = 1..n
    h = x.shape[0]
    return (x[1:n + 1] if top else x[h - 1 - n:h - 1]).flip(0)


def halo_exchange(x: torch.Tensor, lo: int, hi: int, mesh: Mesh,
                  axis: str = "row", edge: str = "clamp") -> torch.Tensor:
    """The local row shard x (rows on dim 0) extended by `lo` rows of the
    previous shard along `axis` and `hi` rows of the next.  Outermost
    shards fill their missing halo per `edge`:
      "clamp"  -- replicate the border row (the reference's clamp-to-edge)
      "zero"   -- zeros
      "bleed"  -- the reference bleed filter's quirky rule: above the top
                  row -off mirrors row +off; below the bottom row n-1+off
                  reads row n-1-off.  Exact for radius 1 (the live value);
                  for a larger radius, readers other than the border row
                  see the frame's bottom edge otherwise than the unsharded
                  filter, as in the JAX package.
    The exchange is one all-gather of every shard's edge rows."""
    if edge not in EDGES:
        raise ValueError(f"halo_exchange: edge must be one of {EDGES}")
    h = x.shape[0]
    if lo > h or hi > h or (edge == "bleed" and max(lo, hi) >= h):
        raise ValueError(f"halo_exchange: a halo of {max(lo, hi)} rows "
                         f"exceeds the shard's {h}")
    n, idx = mesh.shape[axis], mesh.axis_index(axis)
    from_prev = from_next = None
    if n > 1 and (lo or hi):
        parts = all_gather(torch.cat([x[:hi], x[h - lo:]]), mesh, axis)
        if idx > 0:
            from_prev = parts[idx - 1][hi:]
        if idx < n - 1:
            from_next = parts[idx + 1][:hi]
    out = []
    if lo:
        out.append(_edge_fill(x, lo, True, edge) if from_prev is None
                   else from_prev)
    out.append(x)
    if hi:
        out.append(_edge_fill(x, hi, False, edge) if from_next is None
                   else from_next)
    return torch.cat(out) if len(out) > 1 else x


def _halo_filter(fn, x, radius: int, mesh: Mesh, axis: str,
                 edge: str = "clamp"):
    """A row stencil of vertical reach `radius` on a shard: exchange,
    apply, crop."""
    ext = halo_exchange(x, radius, radius, mesh, axis, edge=edge)
    return fn(ext)[radius:ext.shape[0] - radius]


class _RowPlan:
    """The static geometry of a row-sharded frame, checked as the JAX
    package's halo path checks it (same refusals, same messages)."""

    def __init__(self, mesh: Mesh, cfg: PipelineConfig, row_axis: str,
                 view_axis: str | None):
        self.mesh, self.cfg = mesh, cfg
        self.row_axis, self.view_axis = row_axis, view_axis
        self.resample = ((cfg.num_rows_out, cfg.num_cols_out)
                         != (cfg.num_rows, cfg.num_cols))
        if self.resample and view_axis is not None:
            raise ValueError("resampled-output interlace is row-sharded "
                             "only; drop the view axis or use identity "
                             "resolution")
        n_dev = self.n_dev = mesh.shape[row_axis]
        self.n_view = mesh.shape[view_axis] if view_axis else 1
        if cfg.num_rows % n_dev:
            raise ValueError(f"num_rows {cfg.num_rows} not divisible by "
                             f"mesh axis {n_dev}")
        if cfg.num_views % self.n_view:
            raise ValueError(f"num_views {cfg.num_views} not divisible by "
                             f"view axis {self.n_view}")
        rows_loc = self.rows_loc = cfg.num_rows // n_dev
        if self.resample:
            # output rows of shard i sample input rows inside shard i's
            # rows up to a small halo (sampling is y * h_in / h_out)
            if cfg.num_rows_out % n_dev:
                raise ValueError(f"num_rows_out {cfg.num_rows_out} not "
                                 f"divisible by mesh axis {n_dev}")
            ho_loc = self.ho_loc = cfg.num_rows_out // n_dev
            i0, i1, _ = lerp_taps(cfg.num_rows_out, cfg.num_rows, "cpu")
            rs_lo = rs_hi = 0
            for i in range(n_dev):
                sl = slice(i * ho_loc, (i + 1) * ho_loc)
                rs_lo = max(rs_lo, i * rows_loc - int(i0[sl].min()))
                rs_hi = max(rs_hi,
                            int(i1[sl].max()) - ((i + 1) * rows_loc - 1))
            self.rs_lo, self.rs_hi = max(rs_lo, 0), max(rs_hi, 0)
            if max(self.rs_lo, self.rs_hi) > rows_loc:
                raise ValueError("resample halo exceeds the shard height; "
                                 "use fewer devices or parallel.sharded")
        self.h_img = 3 * cfg.usd
        max_halo = max(self.h_img, cfg.bilateral_radius, cfg.feather_radius,
                       cfg.bleed_radius)
        if rows_loc < max_halo:
            raise ValueError(
                f"shard height {rows_loc} smaller than the largest halo "
                f"{max_halo}; use fewer devices or a taller frame")
        check_ported(cfg)
        # the XLA engine's plain torch contracts multiply-adds as its
        # jitted frame does
        self.contract = cfg.engine == "xla"
        # the bounds of the JAX package's kernels on this path: B1 and the
        # IRV round take usd <= 64, B7 a disparity reach <= 128
        if cfg.usd > 64:
            raise ValueError(
                "usd must be <= 64 (256-wide kernel windows)" if self.contract
                else "band engine requires usd <= 64 (256-wide kernel "
                "windows); set engine='xla' for larger arms")
        if max(cfg.zero_disp, cfg.num_disp - cfg.zero_disp) > 128:
            raise ValueError("disparity reach exceeds 128 columns")

    def row0(self) -> int:
        """The shard's first row in the frame."""
        return self.mesh.axis_index(self.row_axis) * self.rows_loc


def _shard_disparities(plan: _RowPlan, img_l, img_r, median: bool):
    """A shard's (disp_l, disp_r, out_l, out_r): its rows' disparities
    after the bilateral filter (and a 3x3 median before it, with
    `median`) and their outlier labels after IRV."""
    cfg, mesh, axis = plan.cfg, plan.mesh, plan.row_axis
    usd, h_img, rows_loc = cfg.usd, plan.h_img, plan.rows_loc
    nd, zd = cfg.num_disp, cfg.zero_disp
    row0 = plan.row0()

    ext_l = halo_exchange(img_l, h_img, h_img, mesh, axis)
    ext_r = halo_exchange(img_r, h_img, h_img, mesh, axis)
    arms_l, arms_r = cross_arms_lr(ext_l, ext_r, cfg.ucd, cfg.lcd, usd,
                                   cfg.lsd, row0 - h_img, cfg.num_rows)
    # the stereo core of either engine on the extended rows: exact integer
    # aggregation (the band engine; the XLA engine at xla_agg_qscale > 0)
    # makes each row's result independent of the shard's origin
    disp_l, disp_r = stereo_core(ext_l, ext_r, arms_l, arms_r, cfg)
    sl = slice(h_img, h_img + rows_loc)
    disp_l, disp_r = disp_l[sl].contiguous(), disp_r[sl].contiguous()
    out_l, out_r = dr_dcc(disp_l, disp_r, cfg.dcc_thresh)

    # IRV: fixed rounds, the disparity and label halos exchanged every
    # round; halo rows outside the frame are outliers, which never vote
    irv_rows = slice(h_img - usd, h_img + rows_loc + usd)
    rows_ext = torch.arange(rows_loc + 2 * usd, device=img_l.device)
    rows_ext = rows_ext - usd + row0
    valid = ((rows_ext >= 0) & (rows_ext < cfg.num_rows))[:, None]

    def irv(disp, outl, arms):
        for _ in range(cfg.irv_iterations):
            dx = halo_exchange(disp, usd, usd, mesh, axis, edge="zero")
            ox = halo_exchange(outl, usd, usd, mesh, axis, edge="zero")
            ox = torch.where(valid, ox, torch.ones_like(ox))
            dx, ox = irv_round(dx, ox, arms[:, irv_rows], cfg.irv_thresh_s,
                               cfg.irv_thresh_h, nd, zd, usd)
            disp = dx[usd:usd + rows_loc].contiguous()
            outl = ox[usd:usd + rows_loc].contiguous()
        return disp, outl

    disp_l, out_l = irv(disp_l, out_l, arms_l)
    disp_r, out_r = irv(disp_r, out_r, arms_r)
    del arms_l, arms_r

    if median:
        disp_l, disp_r = (_halo_filter(filter_median, d, 1, mesh, axis)
                          for d in (disp_l, disp_r))
    blf = lambda d: _halo_filter(lambda e: bilateral(e, cfg), d,
                                 cfg.bilateral_radius, mesh,
                                 axis).contiguous()
    return blf(disp_l), blf(disp_r), out_l, out_r


def _shard_masks(plan: _RowPlan, disp_l, disp_r):
    """(mask_l, mask_r, feathered) of a shard: B7's hits (row-local), the
    bleed (B11) on them with the bleed edge's halo, the pipeline's
    `feather` with a clamp halo."""
    cfg, mesh, axis = plan.cfg, plan.mesh, plan.row_axis
    rbl = cfg.bleed_radius
    mask_l, mask_r = (
        _halo_filter(lambda e: dibr_bleed_mask(e, rbl), o, rbl, mesh, axis,
                     edge="bleed").contiguous()
        for o in dibr_occl(disp_l, disp_r))
    feathered = _halo_filter(lambda m: feather(m, cfg), mask_r,
                             cfg.feather_radius, mesh, axis).contiguous()
    return mask_l, mask_r, feathered


def _shard_views(plan: _RowPlan, img_l, img_r, disp_l, disp_r, masks):
    """The shard's (V, rows, W, 3) u8 view stack: the right image, the
    pipeline's `intermediate_views` (B12's view stack on the band engine,
    every view in one launch; the XLA engine's bounded, contracted
    warps), the left image."""
    cfg = plan.cfg
    views = torch.empty((cfg.num_views, *img_l.shape), dtype=U8,
                        device=img_l.device)
    views[0], views[-1] = img_r, img_l
    intermediate_views(img_l, img_r, disp_l, disp_r, masks,
                       synth_shifts(cfg.num_views), cfg, out=views[1:-1])
    return views


def _resampled_interlace(plan: _RowPlan, views):
    """The shard's rows of a resampled interlace: the few view rows the
    lerps reach beyond the shard exchanged (zero-filled at the frame's
    edges: no lerp reads them), the x-lerps, the y-lerp with the shard's
    slice of the frame's taps (each output row sums the same two input
    rows with the same weights as the unsharded resample), then the view
    selection at the global output row."""
    cfg, mesh = plan.cfg, plan.mesh
    idx, dev = mesh.axis_index(plan.row_axis), views.device
    v = views.shape[0]
    vr = views.movedim(1, 0)                        # (rows, V, W, 3)
    if plan.rs_lo or plan.rs_hi:
        vr = halo_exchange(vr, plan.rs_lo, plan.rs_hi, mesh, plan.row_axis,
                           edge="zero")
    ext_v = vr.movedim(0, 1).to(F32)
    sampled = lerp_axis(ext_v, 2, cfg.num_cols_out, plan.contract)
    i0, i1, w = lerp_taps(cfg.num_rows_out, cfg.num_rows, dev)
    sl = slice(idx * plan.ho_loc, (idx + 1) * plan.ho_loc)
    first = idx * plan.rows_loc - plan.rs_lo
    sampled = lerp_gather(sampled, 1, i0[sl] - first, i1[sl] - first, w[sl],
                          plan.contract).to(U8)
    vid = mux_view_pattern(v, plan.ho_loc, cfg.num_cols_out, cfg.angle, dev,
                           idx * plan.ho_loc)
    return torch.gather(sampled, 0, vid[None])[0]


def _view_axis_interlace(plan: _RowPlan, img_l, img_r, disp_l, disp_r,
                         masks):
    """The view axis: this rank synthesizes its num_views / n_view views
    of its rows (`dibr_backward_warp_dyn`, the shift its own), adds each
    view's subpixels to a partial interlace, and one all-reduce sum over
    the view axis assembles the rows (each subpixel samples one view, so
    the partials are disjoint)."""
    cfg, mesh = plan.cfg, plan.mesh
    mask_l, mask_r, feathered = masks
    v, nd, zd = cfg.num_views, cfg.num_disp, cfg.zero_disp
    vloc = v // plan.n_view
    v_idx = mesh.axis_index(plan.view_axis)
    h, w = img_l.shape[:2]
    pattern = mux_view_pattern(v, h, w, cfg.angle, img_l.device, plan.row0())
    partial = torch.zeros((h, w, 3), dtype=torch.int32, device=img_l.device)
    for j in range(vloc):
        vg = v_idx * vloc + j
        if vg == 0:
            view = img_r
        elif vg == v - 1:
            view = img_l
        else:
            shift = float(np.float32(1.0)
                          - np.float32(vg) / np.float32(v - 1.0))
            a = dibr_backward_warp_dyn(img_l, mask_r, disp_r, -shift, nd, zd,
                                       plan.contract)
            b = dibr_backward_warp_dyn(img_r, mask_l, disp_l, 1.0 - shift,
                                       nd, zd, plan.contract)
            view = mux_merge_ab(a, b, feathered)
        partial += torch.where(pattern == vg, view.to(torch.int32), 0)
    return all_reduce_sum(partial, mesh, plan.view_axis).to(U8)


def _shard_images(plan: _RowPlan, sbs, dev):
    """The rank's SBS rows on `dev`, checked, as (img_l, img_r)."""
    cfg = plan.cfg
    sbs = torch.as_tensor(sbs).to(dev)
    want = (plan.rows_loc, 2 * cfg.num_cols, 3)
    if tuple(sbs.shape) != want or sbs.dtype != U8:
        raise ValueError(f"expected this rank's {want} uint8 rows of the "
                         f"SBS frame, got {tuple(sbs.shape)} {sbs.dtype}")
    return tuple(t.contiguous() for t in demux_sbs(sbs))


def row_sharded_frame(mesh: Mesh, cfg: PipelineConfig, row_axis: str,
                      view_axis: str | None, device, median: bool):
    """The row-sharded frame function of `halo_process_frame` (median
    False) and of parallel.sharded (median as the config says)."""
    plan = _RowPlan(mesh, cfg, row_axis, view_axis)
    dev = resolve_device(device)

    def fn(sbs):
        img_l, img_r = _shard_images(plan, sbs, dev)
        disp_l, disp_r, _, _ = _shard_disparities(plan, img_l, img_r, median)
        masks = _shard_masks(plan, disp_l, disp_r)
        if view_axis is not None:
            il = _view_axis_interlace(plan, img_l, img_r, disp_l, disp_r,
                                      masks)
            return disp_l, disp_r, il
        views = _shard_views(plan, img_l, img_r, disp_l, disp_r, masks)
        del masks
        if plan.resample:
            return disp_l, disp_r, _resampled_interlace(plan, views)
        return disp_l, disp_r, mux_multiview_rows(views, cfg.angle,
                                                  plan.row0())

    return fn


def row_sharded_disparities(mesh: Mesh, cfg: PipelineConfig, row_axis: str,
                            device, median: bool):
    """(img_l, img_r) rows of this rank -> their (disp_l, disp_r, out_l,
    out_r): the stereo half of `row_sharded_frame`."""
    plan = _RowPlan(mesh, cfg, row_axis, None)
    dev = resolve_device(device)

    def fn(img_l, img_r):
        imgs = [torch.as_tensor(t).to(dev).contiguous()
                for t in (img_l, img_r)]
        for t in imgs:
            if tuple(t.shape) != (plan.rows_loc, cfg.num_cols, 3):
                raise ValueError(f"expected this rank's ({plan.rows_loc}, "
                                 f"{cfg.num_cols}, 3) rows, got "
                                 f"{tuple(t.shape)}")
        return _shard_disparities(plan, *imgs, median)

    return fn


def halo_process_frame(mesh: Mesh, cfg: PipelineConfig,
                       row_axis: str = "row", view_axis: str | None = None,
                       device=None):
    """A function of this rank's SBS rows -> its (disp_l, disp_r,
    interlaced) rows: the frame row-sharded over the mesh's `row_axis`
    with explicit halo exchanges.  Needs num_rows divisible by the axis
    and each shard at least as tall as the largest halo.  A resampled
    output (out res != in res) needs num_rows_out divisible too and
    returns the shard's (num_rows_out / n, W_out, 3) output rows.

    With `view_axis` (a second mesh axis) the view fan-out is sharded
    too: each rank synthesizes num_views / n_view of the views for its
    rows and one all-reduce over the view axis assembles the interlace.
    The stereo half is replicated along the view axis.

    Outputs equal the port's `process_frame` on the same frame and config
    (use_median off: this path has none, as the JAX one): the band engine
    bit for bit, the XLA engine bit for bit at xla_agg_qscale > 0.
    Collective: every rank of the mesh calls the function on its rows.
    `device` as `process_frame`'s: the rank's CUDA device by default."""
    return row_sharded_frame(mesh, cfg, row_axis, view_axis, device,
                             median=False)
