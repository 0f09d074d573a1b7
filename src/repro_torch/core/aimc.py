"""AIMC device-noise emulation (paper SS VI) (counterpart of
``repro.core.aimc``).

The paper's Noise Injection Unit (NIU) reads, each inference round, the
noiseless weights of AIMC-emulated tiles from a pristine region, injects
fresh device noise and overwrites the weight regions the PU consumes.
The noise model is the reference's (IBM aihwkit's PCM-like convention):
programming noise ``prog * (0.25|w| + 0.05 w_max)``, read noise ``read *
w_max``, and conductance drift ``(t_read / t0) ** -nu``.

Two differences from the reference, both by design:

- **Fixed output tensors.**  The JAX NIU returns a new pytree each round.
  Here :class:`NoiseInjectionUnit` allocates its output tensors once and
  every :meth:`~NoiseInjectionUnit.refresh` writes the round's noisy
  instance into them, in place, and returns the same pytree
  (``unit.params``).  A CUDA graph captured on that pytree (the serving
  engine's decode blocks, ``models.resnet.capture_forward_int8``) reads
  every new round without being captured again.  The pristine pytree is
  never written.
- **int8 ``QTensor`` leaves go through the NIU kernel**
  (``kernels.niu.niu_plan``): one plan over every targeted matrix, built
  once, then one launch a round with one int32 seed per matrix drawn from
  the unit's generator.  It computes the reference's float path on the
  dequantized weights and requantizes onto the same power-of-two grid
  (``repro/kernels/niu.py``'s docstring), but its random stream is a
  counter hash, not ``jax.random``'s: the two agree in distribution
  (``tests/test_torch_aimc.py``).  Float leaves (the LM's bf16 weights)
  take :func:`inject_noise_float`, drawn from a ``torch.Generator`` in
  place of a JAX key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels.niu import niu_plan
from repro_torch.kernels.ref import dtype_scalar


@dataclasses.dataclass(frozen=True)
class AIMCNoiseModel:
    """PCM-like noise parameters (relative to the max programmed weight).

    prog_noise_scale: std of programming error, proportional to |w| with a
        floor -- sigma = scale * (0.25*|w| + 0.05*w_max).
    read_noise_scale: std of per-read (per-inference) noise.
    drift_nu: conductance drift exponent; weights decay as (t/t0)^-nu.
    t_read: seconds since programming at which inference happens.
    """

    prog_noise_scale: float = 0.1
    read_noise_scale: float = 0.02
    drift_nu: float = 0.06
    t_read: float = 3600.0
    t0: float = 20.0

    def enabled(self) -> bool:
        return (
            self.prog_noise_scale > 0
            or self.read_noise_scale > 0
            or self.drift_nu > 0
        )

    def drift(self) -> float:
        """The weights' decay factor at ``t_read`` (1.0 without drift)."""
        return (self.t_read / self.t0) ** (-self.drift_nu) if self.drift_nu > 0 else 1.0


def inject_noise_float(w: torch.Tensor, gen: torch.Generator, model: AIMCNoiseModel) -> torch.Tensor:
    """One fresh noise instance on a float weight tensor, in ``w``'s dtype
    (Python constants rounded to it first, as JAX rounds a weak-typed
    scalar); the normals are drawn from ``gen``."""
    dt = w.dtype

    def s(x: float) -> float:
        return dtype_scalar(x, dt)

    w_max = torch.clamp(w.abs().amax(), min=s(1e-12))
    sigma_prog = s(model.prog_noise_scale) * (s(0.25) * w.abs() + s(0.05) * w_max)
    w_noisy = w + sigma_prog * torch.randn(w.shape, generator=gen, dtype=dt, device=w.device)
    if model.drift_nu > 0:
        w_noisy = w_noisy * s(model.drift())
    if model.read_noise_scale > 0:
        sigma_read = s(model.read_noise_scale) * w_max
        w_noisy = w_noisy + sigma_read * torch.randn(w.shape, generator=gen, dtype=dt,
                                                     device=w.device)
    return w_noisy


def _is_weight_leaf(path: tuple) -> bool:
    # AIMC emulation targets GEMM weight matrices; biases/norms stay digital
    # (the paper's NIU rewrites URAM *weight* regions, biases are static).
    # Embedding tables count: tied embeddings serve as the unembed GEMM.
    leaf_name = str(path[-1]).lower() if path else ""
    return any(s in leaf_name for s in ("w", "kernel", "embed"))


def leaves_with_paths(tree: Any, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` of a nested dict / list / tuple tree, a ``QTensor``
    counting as one leaf; a path is the tuple of dict keys and indices."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


def _replace(tree: Any, subst: dict, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _replace(v, subst, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, subst, path + (i,)) for i, v in enumerate(tree))
    return subst.get(path, tree)


class NoiseInjectionUnit:
    """The NIU: a fresh AIMC noise instance in fixed output tensors each
    round.

    ``pristine`` is never written (the separate HBM region of SS VI).
    ``params`` is the pytree the PU consumes: the leaves ``target_filter``
    leaves out are the pristine ones themselves; every targeted leaf has
    an output tensor of its own, allocated once, holding the pristine
    values until the first :meth:`refresh`.  Targeted ``QTensor`` leaves
    share one ``niu_plan`` (its output buffer, viewed in each leaf's
    shape, with the leaf's exponent); targeted float leaves of two or more
    dimensions take :func:`inject_noise_float`.  ``seed`` seeds the unit's
    own generator, on the parameters' device."""

    def __init__(self, pristine: Any, model: AIMCNoiseModel,
                 target_filter: Optional[Callable] = None, seed: int = 0):
        self.pristine = pristine
        self.model = model
        self.target_filter = target_filter or (lambda path, leaf: _is_weight_leaf(path))
        leaves = leaves_with_paths(pristine)
        subst, qleaves, self._floats = {}, [], []
        for p, x in leaves:
            if not self.target_filter(p, x):
                continue
            if isinstance(x, QTensor):
                qleaves.append((p, x))
            elif isinstance(x, torch.Tensor) and x.dim() >= 2 and x.is_floating_point():
                subst[p] = x.clone()
                self._floats.append((x, subst[p]))
        self.plan = None
        if qleaves:
            self.plan = niu_plan([(x.q.reshape(-1, x.q.shape[-1]) if x.q.dim() >= 2
                                   else x.q.reshape(1, -1), x.exp) for _, x in qleaves])
            for (p, x), out in zip(qleaves, self.plan.outs):
                out.copy_(x.q.reshape(out.shape))
                subst[p] = QTensor(q=out.view(x.q.shape), exp=x.exp)
        self.params = _replace(pristine, subst)
        dev = next((x.q.device if isinstance(x, QTensor) else x.device for _, x in leaves
                    if isinstance(x, (QTensor, torch.Tensor))), torch.device("cpu"))
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    def refresh(self, gen: Optional[torch.Generator] = None) -> Any:
        """New noisy weights for one inference round, written into
        ``params``'s tensors, which it returns; draws from ``gen``, else
        from the unit's own generator."""
        gen = self.generator if gen is None else gen
        m = self.model
        if self.plan is not None:
            dev = self.plan.outs[0].device
            seeds = torch.randint(0, 2 ** 31 - 1, (len(self.plan.outs),), generator=gen,
                                  device=dev, dtype=torch.int32)
            self.plan.refresh(seeds, prog_noise_scale=m.prog_noise_scale,
                              read_noise_scale=m.read_noise_scale, drift=m.drift())
        for w, out in self._floats:
            out.copy_(inject_noise_float(w, gen, m))
        return self.params


def snr_db(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio of a noisy weight tensor, in dB."""
    sig = torch.sum(clean.to(torch.float32) ** 2)
    err = torch.sum((noisy.to(torch.float32) - clean.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(sig / torch.clamp(err, min=1e-30))
