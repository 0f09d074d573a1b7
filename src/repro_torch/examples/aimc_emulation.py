"""AIMC emulation study (paper SS VI): how PCM-style device noise degrades
inference, on the INT8 ResNet and an LM (counterpart of
``examples/aimc_emulation.py``).

    PYTHONPATH=src python -m repro_torch.examples.aimc_emulation [--device cpu]

For each noise scale, the NIU injects a fresh noise instance per
inference round (read-modify-write of the weight regions, as the hardware
NIU does) and the study reports output SNR and decision flips.  On the
CUDA card (the default) each ResNet round is one NIU launch over every
weight matrix, then a replay of the forward captured as one CUDA graph on
the NIU's fixed output tensors; ``--device cpu`` runs the plain versions
and the eager forward.  Weights come from the port's seeded init, so the
numbers differ from the JAX example's.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.aimc import AIMCNoiseModel, NoiseInjectionUnit, snr_db
from repro_torch.kernels.common import resolve_device
from repro_torch.models import api as model_api
from repro_torch.models import resnet


def resnet_study(device=None):
    print("== ResNet-18 (int8, reduced 28x28 input) ==")
    dev = resolve_device(device)
    params = resnet.init_params(18, 0, dev, num_classes=100)
    rng = np.random.default_rng(0)
    imgs = [
        torch.from_numpy(rng.integers(-100, 100, (28, 28, 3), dtype=np.int8)).to(dev)
        for _ in range(4)
    ]
    clean = [resnet.forward_int8(18, params, im) for im in imgs]

    for scale in (0.0, 0.05, 0.1, 0.3):
        model = AIMCNoiseModel(prog_noise_scale=scale, read_noise_scale=scale / 5)
        if scale == 0.0:
            flips, snrs = 0, float("inf")
        else:
            niu = NoiseInjectionUnit(params, model, target_filter=lambda p, leaf: p[-1] == "w")
            if dev.type == "cuda":
                forward = resnet.capture_forward_int8(18, niu.params, imgs[0].shape)
            else:
                def forward(im):
                    return resnet.forward_int8(18, niu.params, im)
            flips = 0
            snrs = []
            for round_i, im in enumerate(imgs):
                niu.refresh(torch.Generator(device=dev).manual_seed(round_i + 1))
                out = forward(im)
                flips += int(out.argmax().item() != clean[round_i].argmax().item())
                snrs.append(float(snr_db(clean[round_i], out)))
            snrs = np.mean(snrs)
        print(f"  prog_noise={scale:4.2f}: top1 flips {flips}/4, "
              f"logit SNR {snrs if np.isfinite(snrs) else float('inf'):.1f} dB")


def lm_study(device=None):
    print("== olmo-1b (smoke) ==")
    dev = resolve_device(device)
    cfg = smoke_variant(get_config("olmo-1b"))
    api = model_api.get_api(cfg)
    params = api.init_params(cfg, 0, dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 24)).astype(np.int32)).to(dev)
    clean, _ = api.prefill(cfg, params, {"tokens": toks})

    for scale in (0.02, 0.1, 0.3):
        niu = NoiseInjectionUnit(params, AIMCNoiseModel(prog_noise_scale=scale))
        outs = []
        for r in range(3):   # three inference rounds, fresh noise each
            noisy = niu.refresh(torch.Generator(device=dev).manual_seed(100 + r))
            logits, _ = api.prefill(cfg, noisy, {"tokens": toks})
            outs.append(logits)
        flip = np.mean([o.argmax().item() != clean.argmax().item() for o in outs])
        snr = np.mean([float(snr_db(clean, o)) for o in outs])
        print(f"  prog_noise={scale:4.2f}: greedy-token flip rate {flip:.2f}, "
              f"logit SNR {snr:.1f} dB over 3 rounds")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resnet_study(args.device)
    lm_study(args.device)


if __name__ == "__main__":
    main()
