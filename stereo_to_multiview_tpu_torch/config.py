"""Pipeline configuration (the port's own copy of the JAX package's
`config.PipelineConfig`).

Every knob of the stereo -> multiview pipeline lives in one frozen
dataclass.  The field names, defaults and `__post_init__` checks are the
JAX package's, so a config can travel between the two packages as a plain
dict (`config_from_dict(dataclasses.asdict(jax_cfg))`).  Fields that only
the JAX package's engines read (`band_nsplit`, `xla_agg_qscale`) are kept so
that such a dict round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All parameters of the stereo->multiview pipeline.

    Disparity convention: cost plane d compares L(x) with
    R(x + (d - zero_disp)); the computed disparity is
    `argmin_d - zero_disp`, spanning [-zero_disp, num_disp - zero_disp).
    """

    # --- geometry ---
    num_rows: int = 360          # input rows (single eye)
    num_cols: int = 640          # input cols (single eye); SBS input is 2x
    num_rows_out: int = 360      # interlaced output rows
    num_cols_out: int = 640      # interlaced output cols

    # --- disparity search ---
    num_disp: int = 64           # number of disparity hypotheses D
    zero_disp: int = 32          # index of zero disparity inside [0, D)

    # --- cost initialization ---
    ad_coeff: float = 10.0       # lambda_AD in 1-exp(-c/lambda)
    census_coeff: float = 30.0   # lambda_census

    # --- cross-based aggregation ---
    ucd: float = 6.0             # color threshold beyond lsd ("upper")
    lcd: float = 20.0            # color threshold within lsd ("lower")
    usd: int = 34                # max arm length ("upper spatial")
    lsd: int = 17                # near/far switch distance ("lower spatial")

    # --- disparity refinement ---
    dcc_thresh: float = 1.0      # LR mismatch threshold
    irv_iterations: int = 5      # voting rounds
    irv_thresh_s: int = 20       # min reliable votes
    irv_thresh_h: float = 0.4    # vote-ratio threshold

    # --- post filters ---
    bilateral_radius: int = 7
    bilateral_sigma_color: float = 5.0
    bilateral_sigma_spatial: float = 10.0
    bleed_radius: int = 1
    feather_radius: int = 10
    feather_sigma: float = 15.0

    # --- view synthesis / mux ---
    num_views: int = 8
    angle: float = 18.43         # lenticular slant, degrees

    # --- compute engine ---
    engine: str = "auto"         # "auto" / "band": the quantized band
                                 # engine; "xla": the XLA engine (float32
                                 # (D, H, W) volumes, plain torch beside
                                 # B1, B7, B8/B9 and the occlusion stage)
    band_nsplit: int = 2         # JAX float band sums only
    band_digits: int = 3         # aggregation precision: the rescale
                                 # shifts keep each pass's input below
                                 # (2^24-1)/(2*usd+1) (3), 2^15 (2) or
                                 # 2^8 (1); exact integers at each
    band_qscale: float = 127.0   # cost quantization scale (127 = u8;
                                 # int16 costs above 127.5, <= 16383)
    band_lossy_wta: bool = False # pass-4 bf16 WTA dial
    xla_agg_qscale: float = 0.0  # XLA engine: integer costs (exact sums)
    band_row_chunk: int = 0      # stereo-core rows per chunk (0 = whole)
    irv_row_chunk: int = 0       # IRV rows per chunk (0 = whole frame)

    # --- optional stages ---
    use_median: bool = False
    use_hslo: bool = False
    hslo_T: float = 15.0
    hslo_H1: float = 1.0
    hslo_H2: float = 3.0

    # --- low-resolution disparity variant ---
    num_rows_disp: int = 0       # 0 => full resolution
    num_cols_disp: int = 0
    disp_scale: float = 1.0

    def __post_init__(self):
        if not (0 < self.zero_disp <= self.num_disp):
            raise ValueError("need 0 < zero_disp <= num_disp")
        if self.num_views < 2:
            raise ValueError("need at least 2 views (view 0 = right source, "
                             "view V-1 = left source)")
        if self.usd < self.lsd:
            raise ValueError("usd must be >= lsd")

    # ---- derived, all static ----

    @property
    def lowres(self) -> bool:
        return self.num_rows_disp > 0 and self.num_cols_disp > 0

    @property
    def disp_range(self) -> Tuple[int, int]:
        """[min, max) of representable disparities."""
        return (-self.zero_disp, self.num_disp - self.zero_disp)

    @property
    def sbs_shape(self) -> Tuple[int, int, int]:
        return (self.num_rows, 2 * self.num_cols, 3)

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        return (self.num_rows_out, self.num_cols_out, 3)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def config_from_dict(d: dict) -> PipelineConfig:
    """Build a PipelineConfig from a plain dict of field values (e.g.
    `dataclasses.asdict` of the JAX package's config).  Unknown keys
    raise, so a knob the port does not know about cannot be dropped
    silently."""
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields: {unknown}")
    return PipelineConfig(**d)


# Configs of the bundled test sequences (bud 640x360, fish 640x384).
BUD = PipelineConfig(num_rows=360, num_cols=640, num_rows_out=360,
                     num_cols_out=640)
FISH = PipelineConfig(num_rows=384, num_cols=640, num_rows_out=384,
                      num_cols_out=640)

# 1080p, 128 disparities, 8 views: the main path's geometry.
HD1080_D128 = PipelineConfig(
    num_rows=1080, num_cols=1920, num_rows_out=1080, num_cols_out=1920,
    num_disp=128, zero_disp=64, num_views=8)

# 1080p stereo to a 4K lenticular panel with the scanline optimisation
# and the median filter on: the HSLO kernel runs once for both eyes and the
# synthesis kernel samples each 4K subpixel's view at four 1080p points.
HD1080_D128_HSLO_4K = HD1080_D128.replace(
    use_hslo=True, use_median=True, num_rows_out=2160, num_cols_out=3840)

# Disparity at half resolution (the reference's adcensus_stm_2 shape),
# synthesis at full resolution on the disparities scaled by 1/disp_scale.
HD1080_LOWRES = PipelineConfig(
    num_rows=1080, num_cols=1920, num_rows_out=1080, num_cols_out=1920,
    num_rows_disp=540, num_cols_disp=960, disp_scale=0.5, num_disp=64,
    zero_disp=32, num_views=8)

# 4K stereo, 16 views: the stereo core and the IRV rounds stream over row
# chunks (the JAX package's 4K preset, field for field).
UHD4K_16V = PipelineConfig(
    num_rows=2160, num_cols=3840, num_rows_out=2160, num_cols_out=3840,
    num_disp=128, zero_disp=64, num_views=16,
    band_row_chunk=540, irv_row_chunk=1080)
