"""Weight streaming in the port's serving engine and launcher, and the
planner's examples, against the JAX package.

``ServeConfig(stream_pu=...)`` on smoke olmo-1b: the engine's ``stream_*``
stats equal the JAX engine's under the same profile, and planning changes
no served token.  ``launch.serve --stream --device cpu`` plans under the
H100 host-offload profile.  The families the port does not serve yet fail
at once, naming their ROADMAP step (staged multi-PU decode, two or more
``stream_pus``, is ``tests/test_torch_stage_decode.py``'s).  ``examples/resnet_paper.py`` steps 3-4 give the
JAX example's schedule and Table I numbers.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core import pu as jpu  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.plan import SearchConfig as JSearch  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core import pu as tpu  # noqa: E402
from repro_torch.examples import quickstart, resnet_paper, weight_streaming  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.plan import SearchConfig as TSearch  # noqa: E402
from repro_torch.runtime.serving import ServeConfig, ServingEngine  # noqa: E402

_P = {}


def _params():
    if "p" not in _P:
        jcfg = jsmoke(jget_config("olmo-1b"))
        _P["p"] = jax.tree.map(
            np.asarray, japi.get_api(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        )
    return _P["p"]


def _served(eng):
    rng = np.random.default_rng(4)
    for n in (9, 14, 6):
        eng.submit(rng.integers(0, 512, n).astype(np.int32))
    streams = {r.uid: r.out_tokens for r in eng.run_until_drained()}
    return streams, {k: v for k, v in eng.stats().items() if k.startswith("stream_")}


def _port(**kw):
    sc = ServeConfig(max_batch=2, max_len=64, max_new_tokens=5, seed=0, **kw)
    return ServingEngine(smoke_variant(get_config("olmo-1b")), interop.from_jax(_params()), sc, "cpu")


def _jax(**kw):
    sc = jserving.ServeConfig(max_batch=2, max_len=64, max_new_tokens=5, seed=0, **kw)
    return jserving.ServingEngine(jsmoke(jget_config("olmo-1b")),
                                  jax.tree.map(jax.numpy.asarray, _params()), sc)


def test_stream_stats_match_jax_engine():
    """Both engines under the reference's host-offload profile: equal
    ``stream_*`` stats and greedy streams."""
    want_streams, want = _served(_jax(stream_pu=jpu.host_offload_config()))
    got_streams, got = _served(_port(stream_pu=tpu.host_offload_config()))
    assert got == want and len(got) == 9
    assert got_streams == want_streams
    # one profile in stream_pus is the single-PU plan
    assert _served(_port(stream_pus=[tpu.host_offload_config()]))[1] == want
    # planning changes nothing that is served
    assert _served(_port())[0] == got_streams


def _jax_plan_stats(pu, search=None):
    """What the JAX engine reports: its decode round's plan, P = max_batch."""
    plan = jserving.plan_model_streaming(jsmoke(jget_config("olmo-1b")), pu, 2, search)
    return {f"stream_{k}": v for k, v in plan.summary().items()}


def test_stream_stats_under_other_profiles_and_search_match_jax():
    small = dict(name="small", r_sa=128, c_sa=128, fast_mem_bytes=300_000,
                 weight_bw_bytes_per_s=32e9, fast_clock_hz=6e9)
    cases = [(tpu.tpu_v5e_config(), jpu.tpu_v5e_config(), None, None)]
    cases += [(tpu.PUConfig(**small), jpu.PUConfig(**small), TSearch(s, seed=2), JSearch(s, seed=2))
              for s in ("beam", "anneal")]
    for t_pu, j_pu, t_search, j_search in cases:
        eng = _port(stream_pu=t_pu, plan_search=t_search)
        got = {k: v for k, v in eng.stats().items() if k.startswith("stream_")}
        assert got == _jax_plan_stats(j_pu, j_search)


def test_launcher_stream_plans_with_the_h100_profile(capsys):
    assert serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "2",
                       "--max-new", "4", "--stream", "--no-warmup"]) == 0
    stats = json.loads(capsys.readouterr().out)
    host = tpu.h100_host_offload_config()
    assert stats["stream_capacity_bytes"] == host.fast_mem_bytes
    assert stats["stream_tiles"] == 2 * 6 + 1 and stats["plan_time_s"] > 0
    assert stats["completed"] == 2 and stats["tokens"] == 8
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--requests", "3", "--max-new", "5"]
    streams = []
    for extra in ([], ["--stream"], ["--stream", "--plan-search", "anneal",
                                     "--plan-search-seed", "3"]):
        args = serve.build_parser().parse_args(argv + extra)
        eng = serve.make_engine(args)
        serve.submit_requests(eng, args)
        streams.append({r.uid: r.out_tokens for r in eng.run_until_drained()})
        assert (eng.streaming_plan is None) == (not extra)
    assert streams[0] == streams[1] == streams[2]
    assert eng.streaming_plan.plan.search.startswith("anneal") and eng.streaming_plan.pu == host


@pytest.mark.parametrize("arch, step", [("mixtral-8x7b", 12), ("mamba2-780m", 12),
                                        ("internvl2-26b", 9)])
def test_unported_families_fail_at_once(arch, step):
    with pytest.raises(NotImplementedError, match=f"step {step}"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--stream"])


# ------------------------------------------------------------ examples ---


@pytest.mark.parametrize("variant", [18, 50])
def test_resnet_paper_steps_3_4_match_jax_example(variant, capsys):
    """The JAX example's own calls (``examples/resnet_paper.py`` steps 3-4)
    against the port example's numbers, and the printed Table I row."""
    layers = jsim.resnet_gemm_layers(variant)
    rows = resnet_paper.schedule_rows(variant)
    for row, pu in zip(rows, (jpu.PU_2X, jpu.PU_1X)):
        tiles = jsim.model_tiles(pu, layers)
        res = jsched.two_phase(tiles, capacity=pu.fast_mem_bytes)
        assert row == dict(
            pu=pu.name, tiles=len(tiles), weight_bytes=sum(t.mem_bytes for t in tiles),
            capacity_bytes=pu.fast_mem_bytes, baseline_stall_s=res.baseline.total_stall,
            adaptive_stall_s=res.adaptive.total_stall, stall_reduction=res.stall_reduction,
            utilization=res.adaptive.utilization,
        )
    fleet = jsim.FleetSim(sims=[("pu1x", jsim.simulate_model(jpu.PU_1X, layers), 5),
                                ("pu2x", jsim.simulate_model(jpu.PU_2X, layers), 5)])
    assert resnet_paper.table_row(variant) == dict(fps=fleet.fps, fps_per_tops=fleet.fps_per_tops,
                                                   tops=fleet.tops)
    assert resnet_paper.main(["--variant", str(variant), "--plan-only"]) is None
    out = capsys.readouterr().out
    fps, per_tops = {18: ("1260.91", "273.64"), 50: ("558.84", "121.28")}[variant]
    assert f"simulated  {fps:>8} FPS   {per_tops:>6} FPS/TOPS" in out
    assert out.count("tiles, weights") == 2


def test_weight_streaming_and_quickstart_examples_run(capsys):
    weight_streaming.main([])
    out = capsys.readouterr().out
    assert "shared memory @ H100" in out and "INFEASIBLE" not in out
    assert out.count("adaptive") == 4          # levels 1, 2 and two archs of level 3
    res = quickstart.main(["--device", "cpu"])
    assert res.adaptive.total_stall == 0.0 and res.baseline.total_stall == 3.0
    assert "quickstart OK" in capsys.readouterr().out
