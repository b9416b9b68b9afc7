"""The port's utils/profiling.py against the JAX package's: the same
StepTimer summary for the same recorded times, device_memory_stats' keys,
and a trace written on the CPU."""

import json

import pytest

from anime_recommendations_tpu.utils import profiling as jprofiling
from anime_recommendations_tpu_torch.utils import profiling

TIMES = {"step": [0.5, 0.1, 0.3, 0.2], "eval": [1.25], "context": [0.75, 0.25]}


def recorded(timer_cls, monkeypatch, module):
    """A timer whose sections took TIMES (the clock is replaced)."""
    ticks = []
    for xs in TIMES.values():
        for x in xs:
            ticks += [10.0, 10.0 + x]
    clock = iter(ticks)
    monkeypatch.setattr(module, "time", type("Clock", (), {
        "perf_counter": staticmethod(lambda: next(clock))}))
    timer = timer_cls()
    for name, xs in TIMES.items():
        for _ in xs:
            with timer.section(name):
                pass
    return timer


def test_step_timer_summary_matches_jax(monkeypatch):
    port = recorded(profiling.StepTimer, monkeypatch, profiling).summary()
    ref = recorded(jprofiling.StepTimer, monkeypatch, jprofiling).summary()
    assert port == ref
    assert set(port) == set(TIMES)
    assert set(port["step"]) == {"count", "total_s", "mean_s", "p50_s", "max_s"}
    assert port["step"]["count"] == 4 and port["step"]["max_s"] == pytest.approx(0.5)


def test_step_timer_dump_writes_the_summary(tmp_path):
    timer = profiling.StepTimer()
    with timer.section("x"):
        pass
    timer.dump(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == timer.summary()


def test_section_records_when_the_body_raises():
    timer = profiling.StepTimer()
    with pytest.raises(KeyError):
        with timer.section("fails"):
            raise KeyError("x")
    assert timer.summary()["fails"]["count"] == 1


def test_device_memory_stats_keys_match_jax():
    port = profiling.device_memory_stats()
    ref = jprofiling.device_memory_stats()
    assert port and ref
    assert all(set(entry) == set(ref[0]) for entry in port)
    # No CUDA here: one CPU entry, its numbers None.
    assert port == [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                     "bytes_limit": None}]


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(tmp_path / "trace"):
        torch.ones(64).sum()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("call", ["profiled", "start_profiler"])
def test_profiler_helpers_need_a_card(call):
    """profiled and start_profiler time kernels on a CUDA card; without one
    they raise before touching torch.profiler."""
    if profiling.torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    fn = {"profiled": lambda: profiling.profiled(lambda: None, reps=1),
          "start_profiler": profiling.start_profiler}[call]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn()


def test_kernel_name_strips_namespaces_templates_and_parameters():
    assert profiling.kernel_name("void (anonymous namespace)::fused_adam_kernel<float, 4>"
                                 "(float*, int)") == "fused_adam_kernel"
    assert profiling.kernel_name("scan::packed_topk_mma_kernel(int)") == "packed_topk_mma_kernel"
