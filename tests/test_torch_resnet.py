"""The port's INT8 arithmetic and ResNet on the CPU, held against the JAX
package.

``core.quant`` is compared bit for bit with ``repro.core.quant`` on the
same numpy inputs.  The ResNet forwards run on one set of quantized
parameters made with numpy in the JAX init's recipe, a JAX tree on one
side and carried across by ``repro_torch.interop`` on the other; the JAX
side runs its Pallas kernels in interpret mode, as
``tests/test_resnet_paper.py`` does.  Tolerances: int8 logits rtol 1e-5 (the int8 trunk is exact; the
float32 mean and fc product may sum in another order), float logits
rtol 1e-4 with atol 1e-5 of the largest logit (float32 convolutions in
another order).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.models import resnet as jr  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import resnet as tr  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ quant --

_EDGES = np.array([5, -5, 2 ** 30, -2 ** 31, 2 ** 31 - 1, 0, 1, -1, 12345, -12345], np.int32)


@pytest.mark.parametrize("shift", [-40, -32, -31, -8, -1, 0, 1, 7, 15, 16, 17, 30, 31, 32, 33, 40])
def test_shift_round_matches_jax(shift):
    rng = np.random.default_rng(shift + 100)
    acc = np.concatenate([_EDGES, rng.integers(-2 ** 31, 2 ** 31, 500).astype(np.int32),
                          rng.integers(-5000, 5000, 500).astype(np.int32)])
    want = np.asarray(jq.shift_round(jnp.asarray(acc), shift))
    for s in (shift, torch.tensor(shift, dtype=torch.int32)):
        got = tq.shift_round(torch.from_numpy(acc), s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("scale", [1e-2, 0.37, 1.0, 3.0, 127 / 64, 1e3])
def test_quantize_matches_jax(scale):
    x = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32) * np.float32(scale)
    jt, tt = jq.quantize(jnp.asarray(x)), tq.quantize(torch.from_numpy(x))
    assert int(tt.exp) == int(jt.exp) and tt.exp.dtype == torch.int32
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.dequantize().numpy(), np.asarray(jt.dequantize()))
    np.testing.assert_array_equal(tq.fake_quant(torch.from_numpy(x)).numpy(),
                                  np.asarray(jq.fake_quant(jnp.asarray(x))))


@pytest.mark.parametrize("scale", [1e-3, 3e-5, 1e6])
def test_dequantize_is_exact_where_xla_exp2_is_not(scale):
    """XLA's float32 ``exp2`` on the CPU is off by up to ~1e-6 relative at
    many integer arguments of magnitude 13 or more (e.g. -15, -16); the
    port's power-of-two scales are exact.  The int8 payloads agree."""
    x = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32) * np.float32(scale)
    jt, tt = jq.quantize(jnp.asarray(x)), tq.quantize(torch.from_numpy(x))
    assert int(tt.exp) == int(jt.exp) and abs(int(tt.exp)) >= 13
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    exact = tt.q.numpy().astype(np.float32) * np.ldexp(np.float32(1), int(tt.exp))
    np.testing.assert_array_equal(tt.dequantize().numpy(), exact)
    np.testing.assert_allclose(np.asarray(jt.dequantize()), exact, rtol=2e-6)


@pytest.mark.parametrize("acc_exp,out_exp", [(-14, -6), (-9, -9), (-3, -7), (-10, 7)])
def test_requantize_matches_jax(acc_exp, out_exp):
    acc = np.random.default_rng(2).integers(-2 ** 24, 2 ** 24, (32, 16)).astype(np.int32)
    want = jq.requantize_i32(jnp.asarray(acc), jnp.int32(acc_exp), jnp.int32(out_exp))
    got = tq.requantize_i32(torch.from_numpy(acc), torch.tensor(acc_exp, dtype=torch.int32),
                            torch.tensor(out_exp, dtype=torch.int32))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    e = tq.quantized_linear_exponents(torch.tensor(-3, dtype=torch.int32), torch.tensor(-5, dtype=torch.int32))
    assert int(e) == int(jq.quantized_linear_exponents(jnp.int32(-3), jnp.int32(-5))) == -8


# ----------------------------------------------------------------- ResNet --


@pytest.mark.parametrize("variant", [18, 50])
def test_conv_specs_match_jax(variant):
    assert [tuple(vars(s).values()) for s in tr.resnet_conv_specs(variant)] == \
        [tuple(vars(s).values()) for s in jr.resnet_conv_specs(variant)]
    assert tr.feature_dim(variant) == jr.feature_dim(variant)


def _params_np(variant, num_classes):
    """Quantized ResNet parameters made with numpy (the JAX init recipe:
    normal * sqrt(2/fan_in), pow2 exponent, bias 0, shift -exp) as a JAX
    tree and as the numpy tree ``interop`` takes."""
    rng = np.random.default_rng(variant)
    shapes = {s.name: ((s.k, s.k, s.cin, s.cout), 2.0 / (s.k * s.k * s.cin))
              for s in jr.resnet_conv_specs(variant)}
    feat = jr.feature_dim(variant)
    shapes["fc"] = ((feat, num_classes), 1.0 / feat)
    pj, pnp = {}, {}
    for name, (shape, var) in shapes.items():
        w = (rng.standard_normal(shape) * np.sqrt(var)).astype(np.float32)
        e = int(np.ceil(np.log2(np.abs(w).max() / 127.0)))
        q = np.clip(np.round(w / np.float32(2.0 ** e)), -128, 127).astype(np.int8)
        bias, shift = np.zeros(shape[-1], np.int32), np.int32(-e)
        pnp[name] = {"w": (q, np.int32(e)), "bias": bias, "shift": shift}
        pj[name] = {"w": jq.QTensor(q=jnp.asarray(q), exp=jnp.int32(e)),
                    "bias": jnp.asarray(bias), "shift": jnp.asarray(shift)}
    return pj, pnp


@pytest.fixture(scope="module", params=[(18, 28), (50, 32)], ids=["resnet18-28", "resnet50-32"])
def forward_case(request):
    variant, size = request.param
    pj, pnp = _params_np(variant, 10)
    img = np.random.default_rng(variant).integers(-100, 100, (size, size, 3), dtype=np.int8)
    return variant, pj, interop.resnet_params_from_jax(pnp, "cpu"), img


def test_forward_int8_matches_jax(forward_case):
    variant, pj, pt, img = forward_case
    want = np.asarray(jr.forward_int8(variant, pj, jnp.asarray(img)))
    common.reset_launches()
    got = tr.forward_int8(variant, pt, torch.from_numpy(img))
    assert not any(common.launch_counts().values())
    assert got.dtype == torch.float32 and want.dtype == np.float32 and got.shape == (10,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert int(got.argmax()) == int(want.argmax())
    assert float(got.abs().max()) > 0


def test_forward_float_matches_jax(forward_case):
    variant, pj, pt, img = forward_case
    want = np.asarray(jr.forward_float(variant, pj, jnp.asarray(img).astype(jnp.float32)))
    got = tr.forward_float(variant, pt, torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    li = tr.forward_int8(variant, pt, torch.from_numpy(img)).numpy()
    assert np.corrcoef(li, got)[0, 1] > 0.7


@pytest.mark.parametrize("shape", [(8, 8, 4), (9, 7, 3), (2, 2, 1)])
def test_maxpool_int8_matches_jax(shape):
    x = np.random.default_rng(0).integers(-128, 128, shape, dtype=np.int8)
    got = tr._maxpool_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr._maxpool_int8(jnp.asarray(x))))
    assert got.dtype == torch.int8


def test_init_params_seeded_and_shaped_like_jax():
    a, b = tr.init_params(18, 3, "cpu", num_classes=10), tr.init_params(18, 3, "cpu", num_classes=10)
    pj, _ = _params_np(18, 10)
    assert list(a) == list(pj)
    for name in a:
        assert torch.equal(a[name]["w"].q, b[name]["w"].q)
        assert tuple(a[name]["w"].q.shape) == pj[name]["w"].q.shape
        assert a[name]["w"].q.dtype == torch.int8 and a[name]["bias"].dtype == torch.int32
        assert int(a[name]["shift"]) == -int(a[name]["w"].exp)
        assert int(a[name]["w"].q.abs().max()) >= 64     # the pow2 scale uses the int8 range
    assert not torch.equal(a["conv1"]["w"].q, tr.init_params(18, 4, "cpu", num_classes=10)["conv1"]["w"].q)


def test_interop_round_trip():
    pj, pnp = _params_np(18, 10)
    pt = interop.resnet_params_from_jax(pnp, "cpu")
    back = interop.to_numpy(pt)
    for name, layer in pnp.items():
        for got, want in zip(back[name]["w"], layer["w"]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(back[name]["bias"], layer["bias"])
        np.testing.assert_array_equal(back[name]["shift"], layer["shift"])
    again = interop.resnet_params_from_jax(back, "cpu")
    assert all(torch.equal(again[n]["w"].q, pt[n]["w"].q) for n in pt)


def test_resnet_paper_example_prints_top5():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.resnet_paper", "--variant", "18",
         "--image-size", "28", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert "ResNet-18: 11.7M int8 weights" in out.stdout
    m = re.search(r"top-5 classes \[([0-9, ]+)\]", out.stdout)
    assert m and len(m.group(1).split(",")) == 5, out.stdout
