"""The port's scaling harness against the JAX package's, on the CPU.

``anime_recommendations_tpu_torch.parallel.scaling_bench.main`` starts one
torch.distributed.run launch of gloo ranks per mesh shape; the JAX
package's main runs on tests/conftest.py's virtual CPU devices in this
process. Both at tiny sizes for the meshes 1x1 and 2x1 and both routings:
the per-mesh lines and the summary must carry the same keys, mesh strings,
device counts, routing and optimizer. Each port rank raises if its last
loss is not finite, so a run that completes trained to finite losses.
Examples/s on the CPU are not compared: they time the host.
"""

import json

import pytest
import torch

from anime_recommendations_tpu.parallel import scaling_bench as jax_bench
from anime_recommendations_tpu_torch.parallel import scaling_bench

TINY = ["--meshes", "1x1", "2x1", "--steps", "2", "--batch", "64", "--users", "64",
        "--anime", "32", "--emb", "8"]


def lines(main, argv, capsys) -> list[dict]:
    capsys.readouterr()
    main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("routing", ["alltoall", "psum"])
def test_scaling_bench_matches_jax_output(routing, capsys):
    got = lines(scaling_bench.main, ["--device", "cpu", "--routing", routing, *TINY], capsys)
    want = lines(jax_bench.main, ["--routing", routing, *TINY], capsys)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:-1], want[:-1]):
        assert set(g) == set(w) == {"mesh", "devices", "routing", "optimizer",
                                     "examples_per_sec", "step_ms"}
        assert {k: g[k] for k in ("mesh", "devices", "routing", "optimizer")} == \
            {k: w[k] for k in ("mesh", "devices", "routing", "optimizer")}
        assert g["examples_per_sec"] > 0 and g["step_ms"] > 0
    assert [r["mesh"] for r in got[-1]["summary"]] == ["1x1", "2x1"]
    assert [set(r) for r in got[-1]["summary"]] == [set(r) for r in want[-1]["summary"]]
    assert got[-1]["summary"][0]["efficiency"] == 1.0


def test_scaling_bench_refuses_meshes_beyond_the_visible_cards(monkeypatch):
    """On cuda a mesh needs one card per rank: no fallback to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        scaling_bench.main(["--device", "cuda", "--meshes", "1x1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards; 1 visible"):
        scaling_bench.main(["--device", "cuda", "--meshes", "2x1"])
