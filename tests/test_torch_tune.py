"""slate_tpu_torch.tune.probe against the JAX package's on the CPU: with
both packages' ``probe.measure`` replaced by the same fixed seconds per
candidate, both ``autotune``s choose the same winner and persist it
under the same op, param, dtype name and size bucket, or persist
nothing (never-regress). Then the port's probe on its own: measure's
warm-up discipline, a real-timing smoke, the CPU's candidate set, a
persisted route taken by the driver, and the out-of-core panel-width
probe (probe_ooc_panel, autotune(ops=("ooc",)))."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import pallas_kernels as jpk
from slate_tpu.tune import cache as jcache
from slate_tpu.tune import probe as jprobe
from slate_tpu.tune import stats as jstats

import slate_tpu_torch as st
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.tune import cache as tcache
from slate_tpu_torch.tune import probe, select, stats


@pytest.fixture(autouse=True)
def tune_env(tmp_path, monkeypatch):
    """Isolated caches and clean counters for both packages."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    monkeypatch.delenv("SLATE_TPU_TORCH_TUNE", raising=False)
    monkeypatch.delenv("SLATE_TPU_TUNE", raising=False)
    for mod in (tcache, jcache):
        mod.reset_cache()
    for mod in (stats, jstats):
        mod.reset()
    yield tmp_path
    for mod in (tcache, jcache):
        mod.reset_cache()
    for mod in (stats, jstats):
        mod.reset()


def _fixed_measure(seconds):
    """A stand-in for probe.measure: the next of `seconds` per call.
    Both packages measure their candidates in the same order (the
    default first, then the candidates as listed), so the n-th call is
    the same label in both."""
    it = iter(seconds)
    return lambda fn, *a, **kw: next(it)


def _entries(path):
    """{(op, dtype name, bucket): values without the probe evidence}."""
    with open(path) as f:
        raw = json.load(f)["entries"]
    out = {}
    for key, v in raw.items():
        op, _backend, _device, dt, bucket = key.split("|")
        out[(op, dt, int(bucket))] = {k: x for k, x in v.items()
                                      if k != "_meta"}
    return out


# op, n, port dtype, reference dtype, seconds in call order, expected
SCENARIOS = {
    # the recursive kernel wins by far: persisted
    "lu_panel.rec_wins": ("lu_panel", 512, torch.float32, np.float32,
                          (1.0, 0.5, 0.9, 0.3),
                          {"method_lu_panel": "pallas_rec"}),
    "lu_panel.bf16_fori_wins": ("lu_panel", 2048, torch.bfloat16,
                                jnp.bfloat16, (1.0, 0.4, 0.9, 0.6),
                                {"method_lu_panel": "fori"}),
    # a win inside WIN_MARGIN of the default: nothing persisted
    "lu_panel.within_margin": ("lu_panel", 1024, torch.float32,
                               np.float32, (1.0, 0.99, 1.5, 1.2), {}),
    # the default wins: nothing persisted
    "lu_panel.default_wins": ("lu_panel", 512, torch.float32, np.float32,
                              (0.5, 0.6, 0.7, 0.8), {}),
    "getrf.nb": ("getrf", 256, torch.float32, np.float32,
                 (1.0, 2.0, 0.7, 0.8), {"nb": 128}),
    "getrf.default_wins": ("getrf", 256, torch.float32, np.float32,
                           (0.7, 2.0, 0.8, 0.9), {}),
    "geqrf.tiled": ("geqrf", 256, torch.float32, np.float32,
                    (1.0, 0.5, 0.9, 0.95), {"nb": 64, "fused_max_n": 0}),
    "heev.dc": ("heev", 64, torch.float32, np.float32, (1.0, 0.5, 0.8),
                {"method_eig": "dc"}),
    "heev.within_margin": ("heev", 64, torch.float32, np.float32,
                           (1.0, 1.5, 0.985), {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autotune_decides_as_reference(name, tune_env, monkeypatch):
    op, n, tdt, jdt, secs, expected = SCENARIOS[name]
    # both packages see all four panel candidates: the port's kernel
    # gates reject the CPU, the reference's interpreted kernels are
    # stood in for (measure never calls the timed functions here)
    monkeypatch.setattr(pk, "lu_panel_eligible", lambda *a: True)
    monkeypatch.setattr(pk, "lu_panel_rec_eligible", lambda *a: True)
    monkeypatch.setattr(jpk, "lu_panel", lambda p: (p, None))
    monkeypatch.setattr(jpk, "lu_panel_rec", lambda p: (p, None))
    monkeypatch.setattr(probe, "measure", _fixed_measure(secs))
    monkeypatch.setattr(jprobe, "measure", _fixed_measure(secs))
    tr = probe.autotune(ops=(op,), n=n, dtype=tdt, device="cpu")
    jr = jprobe.autotune(ops=(op,), n=n, dtype=jdt)
    assert tr[op]["chosen"] == jr[op]["chosen"] == expected
    assert tr[op]["results"] == jr[op]["results"]
    assert sorted(r["seconds"] for r in tr[op]["results"]) == sorted(secs)
    dt = "float32" if tdt == torch.float32 else "bfloat16"
    want = {(op, dt, tcache.size_bucket(n)): expected} if expected else {}
    t_entries = _entries(tr["_cache_path"]) \
        if os.path.exists(tr["_cache_path"]) else {}
    j_entries = _entries(jr["_cache_path"]) \
        if os.path.exists(jr["_cache_path"]) else {}
    assert t_entries == j_entries == want


def test_measure_separates_warmup():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(())

    t = probe.measure(fn, warmup=2, reps=2, min_time=0.0)
    assert t >= 0
    assert len(calls) >= 5            # 2 warmup + sizing + 2 reps


def test_measure_chains_fast_calls():
    """A call below min_time is chained: sizing once, then k calls a
    rep with k = min_time / once."""
    calls = []
    probe.measure(lambda: calls.append(1), warmup=1, reps=3,
                  min_time=0.01)
    assert len(calls) > 1 + 1 + 3


def test_probe_smoke_cpu(tune_env):
    report = probe.autotune(ops=("potrf",), n=64, nb_candidates=(32, 64),
                            reps=1, write=True, device="cpu")
    results = report["potrf"]["results"]
    # driver-default baseline (nb=None) + the two candidates
    assert len(results) == 3
    assert any(r["nb"] is None for r in results)
    assert all(r["seconds"] > 0 for r in results)
    assert os.path.exists(report["_cache_path"])
    assert stats.snapshot()["probe_seconds"] > 0
    tcache.reset_cache()
    chosen = report["potrf"]["chosen"]
    if chosen:
        # a winner beat the default: persisted and served
        assert chosen["nb"] in (32, 64)
        assert select.tuned_int("potrf", "nb", 256, n=64,
                                dtype=torch.float32) == chosen["nb"]
    else:
        # the default won: nothing cached, the frozen fallback served
        assert select.tuned_int("potrf", "nb", 256, n=64,
                                dtype=torch.float32) == 256


def test_probe_lu_panel_cpu_candidates():
    """Off the card the kernels' gates reject, so the panel probe
    measures exactly the cold default and the column loop."""
    results = probe.probe_lu_panel(256, 64, torch.float32, reps=1,
                                   device="cpu")
    assert sorted(str(r["method"]) for r in results) == ["None", "fori"]
    assert all(r["seconds"] > 0 for r in results)


def test_persisted_fori_reroutes_lu_panel(tune_env, monkeypatch):
    """A persisted fori winner is the route _lu_panel then takes: the
    decision counters show the cached route and the column loop runs
    for the bucket's panels (the cold route is the library LU)."""
    monkeypatch.setattr(probe, "measure",
                        _fixed_measure((1.0, 0.5)))    # None, fori
    report = probe.autotune(ops=("lu_panel",), n=256, device="cpu")
    assert report["lu_panel"]["chosen"] == {"method_lu_panel": "fori"}
    tcache.reset_cache()
    stats.reset()
    calls = []
    orig = tlu.lu_panel_fori
    monkeypatch.setattr(tlu, "lu_panel_fori",
                        lambda a: calls.append(a.shape) or orig(a))
    a = np.random.default_rng(0).standard_normal((256, 256)) \
        .astype(np.float32)
    st.getrf(st.Matrix(a, mb=64, device="cpu"), {st.Option.BlockSize: 64})
    snap = stats.snapshot()
    assert snap["decisions"]["lu_panel.method_lu_panel[cached]"] == 4
    assert calls == [(256, 64), (192, 64), (128, 64), (64, 64)]
    with select.disabled():
        calls.clear()
        st.getrf(st.Matrix(a, mb=64, device="cpu"),
                 {st.Option.BlockSize: 64})
    assert calls == []


def test_probe_ooc_panel_cpu():
    """The streamed-Cholesky probe on the CPU at a small n: the frozen
    width (8192, one panel here) and each candidate, fastest first."""
    res = probe.probe_ooc_panel(128, [32, 64], reps=1, device="cpu")
    assert sorted(r["panel_cols"] or 0 for r in res) == [0, 32, 64]
    assert [r["seconds"] for r in res] == sorted(r["seconds"]
                                                 for r in res)
    assert stats.snapshot()["probe_seconds"] > 0


def _ooc_results(seconds, cands):
    """A probe_ooc_panel stand-in: the default's and each candidate's
    fixed seconds, fastest first."""
    def fake(n, candidates, reps=2, device=None):
        assert list(candidates) == cands
        out = [{"panel_cols": None, "seconds": seconds[0]}] + [
            {"panel_cols": int(c), "seconds": t}
            for c, t in zip(candidates, seconds[1:])]
        return sorted(out, key=lambda d: d["seconds"])
    return fake


@pytest.mark.parametrize("seconds,expect", [
    ((1.0, 0.5, 0.9, 1.2), {"panel_cols": 512}),    # n/8 wins
    ((1.0, 0.99, 1.3, 1.2), {}),                     # within the margin
])
def test_autotune_ooc_decides_as_reference(tune_env, monkeypatch,
                                           seconds, expect):
    """autotune(ops=("ooc",)) on the reference's candidates (n/8, n/4,
    n/2): the same winner persisted under the same key as the
    reference's, or nothing within WIN_MARGIN; a persisted width is
    what the streaming drivers then resolve."""
    n = 4096
    cands = [512, 1024, 2048]
    monkeypatch.setattr(probe, "probe_ooc_panel",
                        _ooc_results(seconds, cands))
    monkeypatch.setattr(jprobe, "probe_ooc_panel",
                        _ooc_results(seconds, cands))
    got = probe.autotune(ops=("ooc",), n=n, dtype=torch.float32,
                         device="cpu")
    ref = jprobe.autotune(ops=("ooc",), n=n, dtype=np.float32)
    assert got["ooc"]["chosen"] == ref["ooc"]["chosen"] == expect
    if expect:
        assert _entries(got["_cache_path"]) == _entries(ref["_cache_path"])
        from slate_tpu_torch.linalg import ooc
        tcache.reset_cache()
        assert ooc._panel_cols(None, n, np.float32) == 512
    else:
        assert not os.path.exists(tcache.cache_path()) \
            or _entries(tcache.cache_path()) == {}


def test_autotune_ooc_never_races_the_default_width(tune_env,
                                                   monkeypatch):
    """A candidate equal to the frozen default width (8192) is left out
    of the probe, which measures that width as its baseline anyway: a
    width is persisted only when it differs from the default and beat
    it past WIN_MARGIN, however the two runs of one width fall."""
    monkeypatch.setattr(probe, "probe_ooc_panel",
                        _ooc_results((1.0, 1.2), [4096]))
    got = probe.autotune(ops=("ooc",), n=32768, dtype=torch.float32,
                         device="cpu", ooc_candidates=(4096, 8192))
    assert got["ooc"]["chosen"] == {}
    monkeypatch.setattr(probe, "probe_ooc_panel",
                        _ooc_results((1.0, 0.5), [4096]))
    got = probe.autotune(ops=("ooc",), n=32768, dtype=torch.float32,
                         device="cpu", ooc_candidates=(4096, 8192))
    assert got["ooc"]["chosen"] == {"panel_cols": 4096}


def test_win_margin_is_the_reference_margin():
    assert probe.WIN_MARGIN == jprobe.WIN_MARGIN
