"""Each traffic generator is deterministic by seed, and seeds differ; the
check's sample of requests is too, and spans the window."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import spec

MIXES = sorted(p.stem for p in (spec.BENCH_DIR / "traffic").glob("*.json"))
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def config_of(mix: str) -> dict:
    """The configuration of a cell that runs the mix."""
    name = next(w["config"] for w in BENCH["workloads"]
                if w["traffic"] == mix)
    return spec.load_json(spec.BENCH_DIR / "configs" / f"{name}.json")


def small(mix: str) -> dict:
    params = json.loads((spec.BENCH_DIR / "traffic" / f"{mix}.json")
                        .read_text())
    params["pool"] = 2
    if "points" in params:
        params["points"] = 2000
    return params


def flat(out):
    if isinstance(out, dict):
        return [np.asarray(out["depth"])] + [m for s in out["mask_sets"]
                                             for m in s]
    return [np.asarray(x) for it in out for x in it.values()]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_traffic(mix):
    params = small(mix)
    gen = spec.load_module(spec.BENCH_DIR / "traffic"
                           / f"{params['generator']}.py", "gen_" + mix)
    config = config_of(mix)
    seed = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    a = flat(gen.generate(params, config, seed))
    b = flat(gen.generate(params, config, seed))
    c = flat(gen.generate(params, config, seed + 1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_check_sample_spans_the_window():
    from portbench.harness.runner import Reservoir

    def kept(seed):
        r = Reservoir(8, np.random.default_rng([seed, 0xc4ec]))
        for k in range(2000):
            r.offer(k)
        return sorted(r.kept)

    assert kept(2**31 + 5) == kept(2**31 + 5) != kept(2**31 + 6)
    assert len(set(kept(2**31 + 5))) == 8
    # a uniform sample: across 200 seeds its mean lies near the middle
    mean = np.mean([kept(s) for s in range(200)])
    assert 900 < mean < 1100
