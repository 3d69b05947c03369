"""The paper's R metric, streaming-necessity decision and pipeline model.

The paper (S3) measures a heterogeneous code stage by stage (H2D, KEX,
D2H) and defines the data-transfer ratio

    R = T_H2D / (T_H2D + T_KEX + T_D2H)

as the indicator of whether multiple streams are worthwhile:

  * R small (< ~0.1): not worthwhile -- pipeline fill/drain overhead and the
    programming effort outweigh the hidable transfer time (paper S3.4).
  * R in the middle band: stream it; the ideal gain is bounded by R.
  * R too large (> ~0.9): offloading itself is unprofitable (paper S3.4).

On the H100 the stages are what the paper measured: copies over the PCIe
link by the copy engines (H2D, D2H) and kernels on the SMs (KEX), timed
with CUDA events by ``repro_torch.core.streams.HostStreamExecutor``.

The paper's overlap model is kept verbatim:

    T_single-stream = sum(stages)                         (stage-by-stage)
    T_multi-stream  = max(stages) + (sum - max) / n        (pipeline + fill)

The port's copy of the reference ``core/rmetric.py`` (it imports nothing
of it).  The reference's readers of compiled XLA (``collective_bytes_from_hlo``,
``cost_analysis_scalars``) read ``core.costanalysis.CostTotals`` in the
port and live there; :func:`roofline_from_cost` is here, with the H100's
peaks.
"""

from __future__ import annotations

import dataclasses
import enum

# ----------------------------------------------------------------------------
# Hardware model: one NVIDIA H100 SXM (data sheet, dense rates).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Peak numbers of one card, for roofline denominators and link models."""

    name: str = "h100-sxm"
    peak_flops: float = 989e12  # bf16 tensor cores, FLOP/s
    peak_flops_f32: float = 67e12  # f32 outside the tensor cores, FLOP/s
    hbm_bw: float = 3.35e12  # bytes/s
    hbm_bytes: float = 80e9  # capacity, for fit checks
    nvlink_bw: float = 450e9  # bytes/s each way, to the other cards of the host
    # bytes/s each way off the host: one 400 Gb/s ConnectX-7 InfiniBand port a
    # GPU (NVIDIA DGX H100 data sheet: 8 x 400 Gb/s for 8 GPUs)
    ib_bw: float = 50e9
    cards_per_host: int = 8
    pcie_bw: float = 64e9  # bytes/s each way, PCIe Gen5 x16 (the H2D/D2H link)
    smem_per_sm_bytes: int = 232_448  # shared memory one block can use
    l2_bytes: float = 50e6
    sms: int = 132


H100_SXM = HardwareSpec()


# ----------------------------------------------------------------------------
# Stage times (the paper's H2D / KEX / D2H triple).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageTimes:
    """Seconds per stage for one task (or summed over a task set)."""

    h2d: float
    kex: float
    d2h: float = 0.0

    @property
    def total(self) -> float:
        return self.h2d + self.kex + self.d2h

    @property
    def stages(self) -> tuple[float, float, float]:
        return (self.h2d, self.kex, self.d2h)

    def ratio(self) -> float:
        """The paper's R = transfer / total (H2D flavour, R_{H2D})."""
        if self.total <= 0.0:
            return 0.0
        return self.h2d / self.total

    def transfer_ratio(self) -> float:
        """R counting both transfer stages (used for the decision)."""
        if self.total <= 0.0:
            return 0.0
        return (self.h2d + self.d2h) / self.total


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Three roofline terms (seconds): compute, memory and link traffic."""

    compute: float
    memory: float
    collective: float

    @property
    def total_serial(self) -> float:
        """Unstreamed model: stages serialize (paper's single-stream time)."""
        return self.compute + self.memory + self.collective

    @property
    def total_overlapped(self) -> float:
        """Perfectly streamed model: max of stages (paper's T_multi, no fill)."""
        return max(self.compute, self.memory, self.collective)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute,
            "memory": self.memory,
            "collective": self.collective,
        }
        return max(terms, key=terms.__getitem__)

    def as_stage_times(self) -> StageTimes:
        """Map roofline terms onto the paper's stage triple."""
        return StageTimes(h2d=self.memory, kex=self.compute, d2h=self.collective)

    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the overlapped step time."""
        t = self.total_overlapped
        return self.compute / t if t > 0 else 0.0


# ----------------------------------------------------------------------------
# Streaming-necessity decision (paper S3.4).
# ----------------------------------------------------------------------------


class StreamDecision(enum.Enum):
    NOT_WORTHWHILE = "not-worthwhile"  # R too small: overheads dominate
    STREAM = "stream"  # middle band: stream it
    OFFLOAD_UNPROFITABLE = "offload-unprofitable"  # R too large


# Paper S3.4: >50% of 223 configs sit below R=0.1, deemed not worthwhile;
# R ~ 0.9 deemed offload-unprofitable.
R_LOW = 0.10
R_HIGH = 0.90


def streaming_decision(
    times: StageTimes, *, r_low: float = R_LOW, r_high: float = R_HIGH
) -> StreamDecision:
    r = times.transfer_ratio()
    if r < r_low:
        return StreamDecision.NOT_WORTHWHILE
    if r > r_high:
        return StreamDecision.OFFLOAD_UNPROFITABLE
    return StreamDecision.STREAM


# ----------------------------------------------------------------------------
# Pipeline (multi-stream) time model.
# ----------------------------------------------------------------------------


def single_stream_time(times: StageTimes) -> float:
    """Stage-by-stage execution: stages serialize (paper's baseline)."""
    return times.total


def multi_stream_time(times: StageTimes, n_streams: int) -> float:
    """The paper's pipelined execution time with ``n_streams`` streams:
    ``max_stage + (sum_stages - max_stage) / n_streams``."""
    if n_streams <= 1:
        return single_stream_time(times)
    s = times.total
    m = max(times.stages)
    return m + (s - m) / n_streams


def optimal_streams(
    times: StageTimes, *, max_streams: int = 64, overhead_per_task: float = 0.0
) -> int:
    """The stream count minimizing modeled time (Gomez-Luna-style [4]);
    ``overhead_per_task`` models per-task management cost."""
    best_n, best_t = 1, single_stream_time(times)
    for n in range(2, max_streams + 1):
        t = multi_stream_time(times, n) + overhead_per_task * n
        if t < best_t - 1e-12:
            best_n, best_t = n, t
    return best_n


def streaming_speedup(times: StageTimes, n_streams: int) -> float:
    """Modeled improvement of multi-stream over single-stream, as a
    fraction: ``1 - T_multi / T_single`` (the paper's figures)."""
    t1 = single_stream_time(times)
    tn = multi_stream_time(times, n_streams)
    if t1 <= 0.0:
        return 0.0
    return 1.0 - tn / t1


def roofline_from_cost(
    *,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    n_chips: int,
    hw: HardwareSpec = H100_SXM,
) -> RooflineTerms:
    """The three roofline terms of one step (reference
    ``rmetric.roofline_from_cost``): each rank's flops over the bf16 peak,
    its bytes over HBM, its collective bytes over the link.  The counts are
    per rank already (``core.costanalysis`` counts a rank's local shards).
    The link: NVLink within one host of ``cards_per_host`` cards, else the
    InfiniBand port of each card (a 16-wide axis of 8-card hosts spans two
    hosts)."""
    link_bw = hw.nvlink_bw if n_chips <= hw.cards_per_host else hw.ib_bw
    return RooflineTerms(
        compute=hlo_flops / hw.peak_flops,
        memory=hlo_bytes / hw.hbm_bw,
        collective=collective_bytes / link_bw,
    )


def model_flops(n_params: float, n_tokens: float, *, backward: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D for train (2*N*D forward-only)."""
    per_token = 6.0 * n_params if backward else 2.0 * n_params
    return per_token * n_tokens


def lavamd_counterexample() -> tuple[StageTimes, float]:
    """The paper's measured lavaMD negative case (S5): the single-stream
    stage times and the measured multi-stream total (0.7242 s), which
    exceeds the single-stream total (halo bytes ~= payload bytes)."""
    return StageTimes(h2d=0.3476, kex=0.3380, d2h=0.0), 0.7242
