"""Multi-PU plan partitioning: split one model across K PU profiles.

The paper scales throughput by instantiating several PUs; its evaluation
(SS V) runs one *frame per PU*, which makes fleet FPS purely additive
(the old ``FleetSim`` model).  Real scaling of a single stream -- the
N3H-Core observation -- comes from *partitioning* one network across
heterogeneous compute cores.  This module implements that as a pipeline:

1. **Contiguous layer-range partitioning balanced on exec time**: an
   exact DP over (layer boundary, stage) minimizes the bottleneck stage
   compute time, with per-stage costs evaluated under that stage's own
   PU cost model (profiles may be heterogeneous).
2. **Per-PU two-phase scheduling**: each stage plans its own tile
   sequence against its own fast-memory capacity and load channel with
   the standard two-phase planner, so weight streaming stalls are
   charged per stage.

Steady-state pipeline throughput is ``1 / max_k stage_time_k`` (frames
enter the pipeline at the bottleneck stage rate); single-frame latency
is the sum of stage times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.pu import PUConfig
from repro_torch.plan.ir import ExecutionPlan


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One pipeline stage: a contiguous layer range on one PU.

    Beyond the stage's own two-phase schedule, the stage carries the
    *handoff metadata* the stage-parallel runtime needs: named tiles
    grouped by consuming layer (so an executor can fold tile outputs
    back into per-layer activations) and the inbound-activation transfer
    charged on the stage boundary (the inter-stage buffering cost the
    FPGA survey flags as the pipeline-scalability bottleneck).
    """

    pu: PUConfig
    layer_start: int
    layer_stop: int                  # exclusive
    plan: ExecutionPlan              # two-phase plan of the stage's tiles
    compute_s: float                 # all-weights-resident stage latency
    tile_names: Tuple[str, ...] = ()       # one per plan tile, index order
    tiles_per_layer: Tuple[int, ...] = ()  # tile count per local layer
    handoff_in_bytes: int = 0        # activation bytes entering the stage
    handoff_in_s: float = 0.0        # inbound transfer time per frame
    # model-layer range the stage's *decode slice* covers (what the model
    # slicers consume -- distinct from layer_start/stop, which index the
    # schedulable unit sequence, e.g. GEMMs).  -1 until a model-aware
    # planner (serving.plan_partitioned_streaming) attaches it, snapped
    # to the family's allowed slice points.
    decode_layer_start: int = -1
    decode_layer_stop: int = -1

    @property
    def decode_layers(self) -> Tuple[int, int]:
        if self.decode_layer_start < 0:
            raise ValueError(
                "stage has no decode layer range attached (plan was built "
                "from a raw unit sequence, not via a model-aware planner)"
            )
        return (self.decode_layer_start, self.decode_layer_stop)

    @property
    def stage_s(self) -> float:
        """Stage time per frame: compute plus weight-streaming stalls."""
        return self.compute_s + self.plan.total_stall

    @property
    def stage_s_with_handoff(self) -> float:
        """Stage occupancy per frame including the inbound handoff."""
        return self.stage_s + self.handoff_in_s

    @property
    def n_layers(self) -> int:
        return self.layer_stop - self.layer_start


@dataclasses.dataclass(frozen=True)
class PartitionedPlan:
    """A model split across K PUs as a synchronous pipeline."""

    stages: Tuple[StagePlan, ...]

    @property
    def feasible(self) -> bool:
        return all(s.plan.feasible for s in self.stages)

    @property
    def bottleneck_s(self) -> float:
        return max(s.stage_s for s in self.stages)

    @property
    def fps(self) -> float:
        return 1.0 / self.bottleneck_s

    @property
    def latency_s(self) -> float:
        return sum(s.stage_s for s in self.stages)

    @property
    def tops(self) -> float:
        return sum(s.pu.peak_ops_per_s for s in self.stages) / 1e12

    @property
    def fps_per_tops(self) -> float:
        return self.fps / self.tops

    # ---- pipeline-dynamics predictions (microbatched execution) -------

    def bubble_prediction(self, n_microbatches: int) -> float:
        """GPipe fill/drain bubble floor: (K-1)/(M+K-1).

        Shared with ``parallel.pipeline.bubble_fraction`` so the
        executed pipeline and the shard_map runner are checked against
        the same analytic model.
        """
        from repro_torch.parallel.pipeline import bubble_fraction

        return bubble_fraction(len(self.stages), n_microbatches)

    def pipeline_events(
        self, n_microbatches: int
    ) -> "np.ndarray":
        """Predicted (K, M) completion times of every (stage, frame).

        Exact recurrence of the synchronous pipeline the executor runs:
        ``done[k][f] = max(done[k][f-1], done[k-1][f] + handoff_k)
        + stage_s_k`` with all microbatches available to stage 0 at t=0.
        """
        K, M = len(self.stages), n_microbatches
        done = np.zeros((K, M))
        for k, s in enumerate(self.stages):
            for f in range(M):
                ready = done[k - 1, f] + s.handoff_in_s if k else 0.0
                prev = done[k, f - 1] if f else 0.0
                done[k, f] = max(ready, prev) + s.stage_s
        return done

    def decode_pipeline_events(
        self,
        n_groups: int,
        n_rounds: int,
        group_scale: float = None,
    ) -> "np.ndarray":
        """Predicted (K, R*M) completion times of the *overlapped staged
        decode* schedule: R rounds, each split into M lane-group frames
        carrying ``group_scale`` (default ``1/M``) of the slot batch.

        Frame ``i = r*M + g`` is lane group ``g`` of round ``r``.  Same
        recurrence as :meth:`pipeline_events` with stage/handoff times
        prorated by the group scale, plus the cross-round sampling
        dependency: group ``g`` of round ``r+1`` may enter stage 0 only
        after group ``g`` of round ``r`` drained the last stage (its
        logits feed the sampled token the next round consumes).  This is
        what the executed virtual clock must reproduce for ``clock_ok``.
        """
        K, M, R = len(self.stages), n_groups, n_rounds
        scale = (1.0 / n_groups) if group_scale is None else group_scale
        done = np.zeros((K, R * M))
        for i in range(R * M):
            for k, s in enumerate(self.stages):
                if k:
                    ready = done[k - 1, i] + s.handoff_in_s * scale
                else:
                    ready = done[K - 1, i - M] if i >= M else 0.0
                prev = done[k, i - 1] if i else 0.0
                done[k, i] = max(ready, prev) + s.stage_s * scale
        return done

    def pipeline_makespan(self, n_microbatches: int) -> float:
        return float(self.pipeline_events(n_microbatches)[-1, -1])

    def pipeline_fps(self, n_microbatches: int) -> float:
        """Predicted throughput of an M-microbatch burst (incl. fill)."""
        return n_microbatches / self.pipeline_makespan(n_microbatches)

    def summary(self) -> dict:
        return {
            "stages": [
                {
                    "pu": s.pu.name,
                    "layers": [s.layer_start, s.layer_stop],
                    "compute_s": s.compute_s,
                    "stall_s": s.plan.total_stall,
                    "stage_s": s.stage_s,
                    "tiles": s.plan.n,
                    "handoff_in_bytes": s.handoff_in_bytes,
                    "handoff_in_s": s.handoff_in_s,
                    "decode_layers": (
                        [s.decode_layer_start, s.decode_layer_stop]
                        if s.decode_layer_start >= 0
                        else None
                    ),
                }
                for s in self.stages
            ],
            "fps": self.fps,
            "latency_s": self.latency_s,
            "bottleneck_s": self.bottleneck_s,
            "fps_per_tops": self.fps_per_tops,
            "feasible": self.feasible,
        }


def snap_boundaries_nonempty(
    raw_bounds: Sequence[float],
    slice_points: Sequence[int],
    n_layers: int,
) -> List[int]:
    """Snap K-1 interior stage boundaries onto allowed slice points,
    keeping every stage non-empty whenever enough interior points exist.

    Each raw boundary picks the nearest *interior* slice point (strictly
    above the previous pick) that still leaves enough distinct interior
    points for the boundaries after it -- so a boundary never greedily
    grabs a point that forces a later stage empty.  Only when the
    feasibility lookahead fails (more boundaries than interior points
    remain, i.e. K exceeds what the slice grid can host) does a boundary
    fall back to the nearest monotone point, which may duplicate its
    neighbour and yield an empty stage -- the documented K-too-large
    degenerate case.
    """
    pts = sorted(set(slice_points))
    interior = [p for p in pts if 0 < p < n_layers]
    n_bounds = len(raw_bounds)
    out: List[int] = []
    prev = 0
    for i, b in enumerate(raw_bounds):
        after = n_bounds - i - 1
        feasible = [
            p for p in interior
            if p > prev and sum(1 for q in interior if q > p) >= after
        ]
        if feasible:
            c = min(feasible, key=lambda q: (abs(q - b), q))
        else:
            allowed = [p for p in pts if prev <= p <= n_layers]
            c = min(allowed, key=lambda q: (abs(q - b), q))
        out.append(c)
        prev = c
    return out


def balance_layer_ranges(
    stage_costs: np.ndarray,
) -> List[Tuple[int, int]]:
    """Min-bottleneck contiguous partition of L layers into K stages.

    ``stage_costs[k, i]`` is layer *i*'s cost on stage *k*'s PU.  Exact
    DP: ``f[k][i]`` = best bottleneck for layers[:i] on stages[:k+1],
    requiring every stage non-empty.  O(K * L^2).
    """
    K, L = stage_costs.shape
    if K > L:
        raise ValueError(f"cannot split {L} layers into {K} non-empty stages")
    prefix = np.zeros((K, L + 1))
    prefix[:, 1:] = np.cumsum(stage_costs, axis=1)

    INF = math.inf
    f = np.full((K, L + 1), INF)
    cut = np.zeros((K, L + 1), np.int64)
    f[0, 1:] = prefix[0, 1:]
    for k in range(1, K):
        for i in range(k + 1, L + 1):
            best, best_j = INF, k
            # stage k covers layers [j, i); previous stages cover [:j)
            for j in range(k, i):
                b = max(f[k - 1, j], prefix[k, i] - prefix[k, j])
                if b < best:
                    best, best_j = b, j
            f[k, i] = best
            cut[k, i] = best_j
    # recover boundaries
    bounds = [L]
    i = L
    for k in range(K - 1, 0, -1):
        i = int(cut[k, i])
        bounds.append(i)
    bounds.append(0)
    bounds.reverse()
    return [(bounds[s], bounds[s + 1]) for s in range(K)]


def partition_layers(
    layers: Sequence,
    pus: Sequence[PUConfig],
    *,
    latency_s,
    tiles_of,
    name_of=None,
    act_bytes_of=None,
    use_cache: bool = True,
    search=None,
) -> PartitionedPlan:
    """Partition an arbitrary layer sequence across ``pus``.

    ``latency_s(pu, layer) -> float`` costs one layer on one PU (drives
    the balancing DP and the stage compute account); ``tiles_of(pu,
    layer) -> [TileCost]`` produces the stage's schedulable tiles.
    ``name_of(layer) -> str`` names the layer's tiles (executor handoff
    metadata); ``act_bytes_of(layer) -> int`` sizes the layer's *input*
    activations, charged as the handoff into the stage that starts with
    that layer.  ``search`` (a ``repro_torch.plan.SearchConfig``) selects the
    per-stage schedule-search strategy; it is part of each stage plan's
    cache key.

    Degenerate shapes fall back to the single-PU path rather than
    producing empty stages: K > L cannot fill K non-empty contiguous
    ranges, so the whole model is planned as one stage on ``pus[0]``
    (K = 1 is the same path via the trivial DP).
    """
    from repro_torch.plan.cache import plan_cached
    from repro_torch.plan.planner import plan as _plan

    K = len(pus)
    L = len(layers)
    if K == 0:
        raise ValueError("need at least one PU profile")
    if L == 0:
        raise ValueError("need at least one layer")
    if K > L:
        pus = pus[:1]
        K = 1
    if name_of is None:
        name_of = lambda l: getattr(l, "name", None) or f"layer{id(l)}"
    costs = np.array([[latency_s(pu, l) for l in layers] for pu in pus])
    ranges = balance_layer_ranges(costs)

    stages = []
    for s, (pu, (start, stop)) in enumerate(zip(pus, ranges)):
        tiles: List = []
        tile_names: List[str] = []
        tiles_per_layer: List[int] = []
        for li, layer in enumerate(layers[start:stop]):
            layer_tiles = tiles_of(pu, layer)
            base = name_of(layer)
            tiles_per_layer.append(len(layer_tiles))
            tile_names.extend(
                f"{base}/t{j}" for j in range(len(layer_tiles))
            )
            tiles.extend(layer_tiles)
        if use_cache:
            stage_plan = plan_cached(tiles, pu.fast_mem_bytes, search=search)
        else:
            stage_plan = _plan(tiles, pu.fast_mem_bytes, search=search)
        handoff_bytes = (
            int(act_bytes_of(layers[start]))
            if (s > 0 and act_bytes_of is not None)
            else 0
        )
        stages.append(
            StagePlan(
                pu=pu,
                layer_start=start,
                layer_stop=stop,
                plan=stage_plan,
                compute_s=float(costs[s, start:stop].sum()),
                tile_names=tuple(tile_names),
                tiles_per_layer=tuple(tiles_per_layer),
                handoff_in_bytes=handoff_bytes,
                handoff_in_s=handoff_bytes / pu.act_bw_bytes_per_s,
            )
        )
    return PartitionedPlan(stages=tuple(stages))


def partition_gemms(
    gemms: Sequence[Tuple[str, int, int, int]],
    pus: Sequence[PUConfig],
    *,
    layer_latency_s=None,
    use_cache: bool = True,
    search=None,
) -> PartitionedPlan:
    """Partition a (name, N, M, P) GEMM sequence across ``pus``.

    ``layer_latency_s(pu, (name, n, m, p)) -> float`` overrides the
    per-layer cost model; the default charges the PU's systolic-array
    execution time (the simulator layers richer I/O modelling on top via
    ``core.simulator.simulate_partitioned``).
    """
    if layer_latency_s is None:
        layer_latency_s = lambda pu, g: pu.exec_time(g[2], g[3], g[1])
    return partition_layers(
        list(gemms),
        pus,
        latency_s=layer_latency_s,
        tiles_of=lambda pu, g: pu.gemm_tiles(g[1], g[2], g[3]),
        name_of=lambda g: g[0],
        # inbound activations of (name, N, M, P): the M x P int8 operand
        act_bytes_of=lambda g: g[2] * g[3],
        use_cache=use_cache,
        search=search,
    )
