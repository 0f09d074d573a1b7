"""Weight streaming of the INT8 ResNet's GEMMs: the paper's two-phase plan
driving the hand-written ``int8_gemm`` (paper SS III, on the card).

The paper's FPGA streams each R_SA-row weight tile from HBM into URAM while
the systolic array runs the tiles before it.  Here the hierarchy is one
level up: every tile's weights wait in pinned host memory, and a tile is
copied into a :class:`TileArena` -- one device buffer of the PU's
fast-memory capacity, the URAM's counterpart -- in the plan's issue order
(:class:`~repro_torch.core.streaming.StreamingExecutor`).  Once the
executor retires it, in inference order, the tile's GEMM runs through the
``int8_gemm`` kernel against its call's activations, and its slot is free
for the next load.  On the card the copies run on a stream of their own:
a tile's GEMM waits for its copy, and a copy waits for the GEMMs retired
before it was issued (whose slots it may reuse).

:func:`forward_calls` records one forward's GEMM calls with their operands:
the convolutions (the patch matrix, or the map itself where the main path
sends the convolution to the GEMM's conv mode) and the fc's weights applied
by the same GEMM to the trunk's last map.  The forward computes its fc in
float32 after the average pool; the PU's form of it is an int8 GEMM, and
pool and fc commute, so the stream runs the fc's 16 tiles that way.
A tile covers ``R_SA`` output channels (columns of the ``(M, N)`` weight
view), so each call's streamed outputs, joined along the channels, must
equal the resident call's bit for bit: every output channel is its own
int32 sum whatever the split of the reduction.

:func:`stream_partitioned` is the multi-PU sibling of :func:`stream_calls`:
the calls are split into contiguous stages over several PU profiles
(``core.simulator.simulate_partitioned``, the paper's per-layer cost
model) and a batch of images runs through the stage pipeline
(``runtime.pipeline_exec.StagePipelineExecutor``), one image a
microbatch.  Each stage streams its own tiles into its own arena on its
own copy stream, in its plan's issue order, while the other stage works
on another image.
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import simulator as sim
from repro_torch.core.pu import PUConfig
from repro_torch.core.streaming import (
    StreamingExecutor,
    StreamingPlan,
    WeightTile,
    gemm_sequence_tiles,
    plan_streaming,
)
from repro_torch.kernels import ops
from repro_torch.models import resnet
from repro_torch.plan.partition import PartitionedPlan
from repro_torch.runtime.pipeline_exec import PipelineReport, StagePipelineExecutor

# the module (the package re-exports its function under the same name)
kgemm = importlib.import_module("repro_torch.kernels.int8_gemm")

ALIGN = 16      # bytes: the conv mode's operand alignment
ARENA_WAIT_S = 60.0     # longest a stage's load waits for room in its arena


@dataclasses.dataclass(eq=False)
class GemmCall:
    """One weight GEMM of the forward: ``post(a @ w + bias)`` over the
    weights' ``(M, N)`` view (a conv's ``(k*k*Cin, Cout)``), on a patch
    matrix ``a`` or, in the conv mode, on the map ``img``; ``out`` is the
    resident call's output, ``(P, N)`` or ``(OH, OW, N)``."""
    name: str
    w: torch.Tensor
    bias: torch.Tensor
    shift: Union[int, torch.Tensor]
    relu: bool
    out: torch.Tensor
    a: Optional[torch.Tensor] = None
    img: Optional[torch.Tensor] = None
    residual: Optional[torch.Tensor] = None
    k: int = 1
    stride: int = 1
    pad: int = 0

    @property
    def conv_mode(self) -> bool:
        return self.img is not None

    @property
    def m(self) -> int:
        return self.w.shape[0]

    @property
    def n(self) -> int:
        return self.w.shape[1]

    @property
    def p(self) -> int:
        return self.out.numel() // self.n

    def run(self, w_cols: torch.Tensor, c0: int) -> torch.Tensor:
        """The GEMM over output channels ``[c0, c0 + w_cols.shape[1])``
        with their weights ``w_cols`` (M, rows), contiguous."""
        c1 = c0 + w_cols.shape[1]
        bias = self.bias[c0:c1]
        res = None if self.residual is None else self.residual[..., c0:c1].contiguous()
        if self.conv_mode:
            cin = self.img.shape[-1]
            return kgemm.int8_conv_gemm(
                self.img, w_cols.view(self.k, self.k, cin, c1 - c0), bias, self.shift, res,
                k=self.k, stride=self.stride, pad=self.pad, relu=self.relu,
            )
        return kgemm.int8_gemm_pn(self.a, w_cols, bias, self.shift, res, relu=self.relu,
                                  w_layout="mn")

    def resident(self) -> torch.Tensor:
        """The whole call at once, all its weights resident."""
        return self.run(self.w.contiguous(), 0)


def forward_calls(
    variant: int,
    params: dict,
    img: torch.Tensor,
    conv_mode: Callable = ops.takes_conv_mode,
) -> List[GemmCall]:
    """The weight GEMMs of one int8 forward, in execution order: each
    convolution (the main path's own output as ``out``) and then the fc
    over the trunk's last map.  ``conv_mode(x, w4d, k, stride, pad)``
    picks the calls that read the map (default: the main path's choice)."""
    trunk, convs = resnet.trunk_int8_calls(variant, params, img)
    calls: List[GemmCall] = []
    for spec, x, res, out in convs:
        p = params[spec.name]
        w4d = p["w"].q
        gather = conv_mode(x, w4d, spec.k, spec.stride, spec.pad)
        flat = (lambda t: t) if gather else (lambda t: t.reshape(-1, spec.cout))
        calls.append(GemmCall(
            name=spec.name, w=w4d.reshape(-1, spec.cout), bias=p["bias"], shift=p["shift"],
            relu=spec.relu, out=flat(out),
            a=None if gather else ops.im2col(x, spec.k, spec.stride, spec.pad),
            img=x if gather else None,
            residual=None if res is None else flat(res),
            k=spec.k, stride=spec.stride, pad=spec.pad,
        ))
    fc = params["fc"]
    a = trunk.reshape(-1, trunk.shape[-1])
    out = kgemm.int8_gemm_pn(a, fc["w"].q, fc["bias"], fc["shift"], w_layout="mn")
    calls.append(GemmCall(name="fc", w=fc["w"].q, bias=fc["bias"], shift=fc["shift"],
                          relu=False, out=out, a=a))
    return calls


def call_tiles(calls: Sequence[GemmCall], pu: PUConfig) -> List[WeightTile]:
    """The calls' R_SA-row tiles (``core.streaming.gemm_sequence_tiles``)."""
    return gemm_sequence_tiles([(c.name, c.n, c.m, c.p) for c in calls], pu)


def simulator_differences(
    calls: Sequence[GemmCall], variant: int, pu: PUConfig
) -> List[str]:
    """How the forward's tiles differ from the simulator's
    (``simulator.model_tiles(pu, resnet_gemm_layers(variant))``), one
    line a difference."""
    layers = sim.resnet_gemm_layers(variant)
    ours = {c.name: (c.n, c.m, c.p) for c in calls}
    theirs = {l.name.replace("conv", "c") if l.name != "conv1" else l.name: (l.n, l.m, l.p)
              for l in layers}
    out = [f"{len(call_tiles(calls, pu))} tiles in {len(calls)} calls; the simulator "
           f"{len(sim.model_tiles(pu, layers))} tiles in {len(layers)} layers"]
    for name, (n, m, p) in theirs.items():
        if name not in ours:
            out.append(f"{name} (N={n}, M={m}, P={p}, {-(-n // pu.r_sa)} tiles) is the "
                       f"simulator's only: the forward pools with a mean, not a GEMM")
    for name, shape in ours.items():
        if name not in theirs:
            out.append(f"{name} is the forward's only")
        elif shape != theirs[name]:
            out.append(f"{name}: (N, M, P) {shape} here, {theirs[name]} in the simulator")
    order = [n for n in ours if n in theirs]
    if order != [n for n in theirs if n in ours]:
        out.append("order: each block's downsample conv runs before its last conv here "
                   "(its output is that conv's residual), after it in the simulator")
    return out


class TileArena:
    """A device buffer of ``capacity`` bytes that holds the resident
    tiles, each at a first-fit offset aligned to ``ALIGN`` bytes."""

    def __init__(self, capacity: int, device: torch.device):
        self.buf = torch.empty(capacity, dtype=torch.int8, device=device)
        self.free_blocks: List[Tuple[int, int]] = [(0, capacity)]   # (offset, size)
        self.high_water = 0

    def fits(self, nbytes: int) -> bool:
        """True when ``nbytes`` fit in one free block."""
        size = -(-nbytes // ALIGN) * ALIGN
        return any(avail >= size for _, avail in self.free_blocks)

    def alloc(self, nbytes: int) -> int:
        size = -(-nbytes // ALIGN) * ALIGN
        for i, (off, avail) in enumerate(self.free_blocks):
            if avail >= size:
                if avail == size:
                    del self.free_blocks[i]
                else:
                    self.free_blocks[i] = (off + size, avail - size)
                self.high_water = max(self.high_water, off + size)
                return off
        raise RuntimeError(
            f"no {size} contiguous bytes free in the {self.buf.numel()}-byte arena "
            f"(free blocks {self.free_blocks})"
        )

    def free(self, off: int, nbytes: int) -> None:
        size = -(-nbytes // ALIGN) * ALIGN
        blocks = sorted(self.free_blocks + [(off, size)])
        merged = [blocks[0]]
        for o, s in blocks[1:]:
            po, ps = merged[-1]
            if po + ps == o:
                merged[-1] = (po, ps + s)
            else:
                merged.append((o, s))
        self.free_blocks = merged


@dataclasses.dataclass
class StreamRun:
    plan: StreamingPlan
    executor: StreamingExecutor
    outputs: List[torch.Tensor]      # per call, the tiles' outputs joined
    bytes_streamed: int
    wall_s: float                    # executor run to the device's last GEMM
    arena_high_water: int


def stream_calls(calls: Sequence[GemmCall], pu: PUConfig) -> StreamRun:
    """Plan the calls' tiles on ``pu`` and run them through the
    :class:`StreamingExecutor`: each tile's weights copied from pinned host
    memory (on the card) into the arena when the plan issues its load, its
    GEMM run when the executor retires it.  An infeasible plan raises."""
    tiles = call_tiles(calls, pu)
    plan = plan_streaming(tiles, pu)
    dev = calls[0].w.device
    cuda = dev.type == "cuda"
    owner = {}
    host = {}
    for t in tiles:
        ci = t.layer_index
        c0 = int(t.name.rsplit("/rows", 1)[1])
        owner[t.name] = (ci, c0)
        h = calls[ci].w[:, c0:c0 + t.n].to("cpu").contiguous()
        host[t.name] = h.pin_memory() if cuda else h
    arena = TileArena(pu.fast_mem_bytes, dev)
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    compute = torch.cuda.current_stream(dev) if cuda else None
    released = torch.cuda.Event() if cuda else None
    loaded = {}

    def fetch(name):
        h = host[name]
        off = arena.alloc(h.numel())
        dst = arena.buf[off:off + h.numel()].view(h.shape)
        if cuda:
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(released)     # the slots retired GEMMs freed
                dst.copy_(h, non_blocking=True)
                loaded[name] = torch.cuda.Event()
                loaded[name].record(copy_stream)
        else:
            dst.copy_(h)
        return name, off, dst

    def run_tile(resident):
        name, off, w_cols = resident
        if cuda:
            compute.wait_event(loaded.pop(name))
        ci, c0 = owner[name]
        out = calls[ci].run(w_cols, c0)
        if cuda:
            released.record(compute)
        arena.free(off, w_cols.numel())
        return out

    ex = StreamingExecutor(plan, fetch=fetch)
    t0 = time.perf_counter()
    outs = ex.run([run_tile] * len(tiles))
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per_call: List[List[torch.Tensor]] = [[] for _ in calls]
    for t, o in zip(tiles, outs):
        per_call[t.layer_index].append(o)
    joined = [torch.cat(parts, dim=-1) for parts in per_call]
    return StreamRun(
        plan=plan, executor=ex, outputs=joined,
        bytes_streamed=sum(h.numel() for h in host.values()),
        wall_s=wall, arena_high_water=arena.high_water,
    )


def partition_calls(calls: Sequence[GemmCall], pus: Sequence[PUConfig]) -> PartitionedPlan:
    """The calls split into ``len(pus)`` contiguous stages, balanced on
    the simulator's per-layer latency under each stage's profile, each
    stage's R_SA-row tiles planned against its profile's capacity
    (``simulator.simulate_partitioned``); a stage's tiles are named
    ``"{call}/t{j}"``, tile j holding output channels from ``j * R_SA``."""
    layers = [sim.GemmLayer(c.name, c.n, c.m, c.p, residual=c.residual is not None)
              for c in calls]
    return sim.simulate_partitioned(list(pus), layers)


@dataclasses.dataclass
class PipelineRun:
    plan: PartitionedPlan
    report: PipelineReport
    outputs: List[List[torch.Tensor]]   # per image, per call: the tiles' outputs joined
    bytes_streamed: int
    wall_s: float                       # executor run to the device's last GEMM
    arena_high_water: List[int]         # per stage


def stream_partitioned(
    calls: Sequence[Sequence[GemmCall]],
    pus: Sequence[PUConfig],
    queue_depth: int = 2,
) -> PipelineRun:
    """Run a batch of images' GEMM calls (``calls[m]``: image m's
    :func:`forward_calls`, one microbatch each) through the stage
    pipeline of :func:`partition_calls` over ``pus``.

    Stage k has an arena of its profile's ``fast_mem_bytes``; ``fetch``
    (stage k's prefetch worker, in the plan's issue order) copies a
    tile's weights from pinned host memory into it on stage k's copy
    stream, and ``run_tile`` (stage k's thread, on its stream) waits for
    that copy and runs the tile's GEMM on the image's own operands of
    the call.  A copy waits for the GEMMs the stage retired before it
    was issued, whose slots it may reuse.  The plan bounds the bytes
    resident, not their layout: a load whose bytes are free but in
    pieces waits for the stage's next retired GEMM (and raises after
    ``ARENA_WAIT_S``).  Every image streams every tile (the executor's
    tile loop runs once a frame).  An infeasible plan raises."""
    images = [list(c) for c in calls]
    first = images[0]
    plan = partition_calls(first, pus)
    dev = first[0].w.device
    cuda = dev.type == "cuda"
    # stage k's tile i -> (call index, first output channel), and its
    # weights on the host
    owner: List[List[Tuple[int, int]]] = []
    host: List[List[torch.Tensor]] = []
    for st in plan.stages:
        o, h = [], []
        for li, n_tiles in enumerate(st.tiles_per_layer):
            ci = st.layer_start + li
            c = first[ci]
            for j in range(n_tiles):
                c0 = j * st.pu.r_sa
                o.append((ci, c0))
                w = c.w[:, c0:c0 + min(st.pu.r_sa, c.n - c0)].to("cpu").contiguous()
                h.append(w.pin_memory() if cuda else w)
        owner.append(o)
        host.append(h)
    K = len(plan.stages)
    arenas = [TileArena(st.pu.fast_mem_bytes, dev) for st in plan.stages]
    # prefetch worker vs stage thread; the worker waits here while the
    # arena's free bytes lie in pieces too small for its tile
    conds = [threading.Condition() for _ in range(K)]
    copy_streams = [torch.cuda.Stream(dev) if cuda else None for _ in range(K)]
    released = [torch.cuda.Event() if cuda else None for _ in range(K)]
    loaded = {}
    outs: List[List[List[torch.Tensor]]] = [[[] for _ in first] for _ in images]

    def fetch(k, i, name):
        h = host[k][i]
        with conds[k]:
            while not arenas[k].fits(h.numel()):
                if not conds[k].wait(timeout=ARENA_WAIT_S):
                    raise RuntimeError(f"stage {k}: {name} found no room in its arena for "
                                       f"{ARENA_WAIT_S} s (free blocks {arenas[k].free_blocks})")
            off = arenas[k].alloc(h.numel())
        dst = arenas[k].buf[off:off + h.numel()].view(h.shape)
        if cuda:
            with torch.cuda.stream(copy_streams[k]):
                copy_streams[k].wait_event(released[k])   # the slots retired GEMMs freed
                dst.copy_(h, non_blocking=True)
                loaded[k, i] = torch.cuda.Event()
                loaded[k, i].record(copy_streams[k])
        else:
            dst.copy_(h)
        return off, dst

    def run_tile(k, i, resident, m):
        off, w_cols = resident
        if cuda:
            torch.cuda.current_stream(dev).wait_event(loaded.pop((k, i)))
        ci, c0 = owner[k][i]
        outs[m][ci].append(images[m][ci].run(w_cols, c0))
        if cuda:
            released[k].record(torch.cuda.current_stream(dev))
        with conds[k]:
            arenas[k].free(off, w_cols.numel())
            conds[k].notify_all()
        return m

    ex = StagePipelineExecutor(
        plan, fetch=fetch, run_tile=run_tile, queue_depth=queue_depth,
        stage_devices=[dev] * K if cuda else None, record_fetch_orders=True,
    )
    if cuda:
        torch.cuda.synchronize(dev)            # the operands are ready
    t0 = time.perf_counter()
    report = ex.run(list(range(len(images))))
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return PipelineRun(
        plan=plan, report=report,
        outputs=[[torch.cat(parts, dim=-1) for parts in per] for per in outs],
        bytes_streamed=len(images) * sum(t.numel() for h in host for t in h),
        wall_s=wall, arena_high_water=[a.high_water for a in arenas],
    )
