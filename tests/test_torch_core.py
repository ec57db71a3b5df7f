"""slate_tpu_torch core against the JAX package: TiledMatrix storage and
densification, pad_diag_identity, options, the tune cache and method
routing, the event bus, and the port's independence from JAX.

The same seeded numpy inputs go through both packages on the CPU; the
port is asked for the CPU explicitly (device="cpu")."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core import tiles as jtiles
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.core import tiles as ttiles
from slate_tpu_torch.core.methods import MethodLUPanel
from slate_tpu_torch.tune import cache as tcache
from slate_tpu_torch.tune import select as tselect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """Isolated port tune cache."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("SLATE_TPU_TORCH_TUNE", raising=False)
    tcache.reset_cache()
    yield tmp_path
    tcache.reset_cache()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- TiledMatrix ----------------------------------------------------------

@pytest.mark.parametrize("shape,mb,nb", [((70, 45), 32, 16),
                                         ((64, 64), 32, None),
                                         ((5, 130), 8, 64)])
def test_from_dense_padding_matches_jax(rng, shape, mb, nb):
    # storage is a zero pad to tile multiples: bitwise equal
    a = rng.standard_normal(shape).astype(np.float32)
    J = jtiles.TiledMatrix.from_dense(a, mb, nb)
    T = ttiles.TiledMatrix.from_dense(a, mb, nb, device="cpu")
    assert (T.m, T.n, T.mb, T.nb, T.mt, T.nt) == \
        (J.m, J.n, J.mb, J.nb, J.mt, J.nt)
    assert np.array_equal(_np(T.data), np.asarray(J.data))
    assert np.array_equal(T.to_numpy(), a)


@pytest.mark.parametrize("ctor,args", [
    ("TriangularMatrix", (jst.Uplo.Lower,)),
    ("TriangularMatrix", (jst.Uplo.Upper,)),
    ("SymmetricMatrix", (jst.Uplo.Lower,)),
    ("HermitianMatrix", (jst.Uplo.Upper,)),
])
def test_structured_to_dense_matches_jax(rng, ctor, args):
    # masks, mirrors and transposes move values without arithmetic
    # (the Hermitian mirror subtracts one exact diagonal copy): bitwise
    a = rng.standard_normal((48, 48)).astype(np.float32)
    J = getattr(jst, ctor)(*args, a, mb=16)
    T = getattr(st, ctor)(st.Uplo[args[0].name], a, mb=16, device="cpu")
    assert np.array_equal(T.to_numpy(), np.asarray(J.to_dense()))
    assert np.array_equal(T.T.to_numpy(), np.asarray(J.T.to_dense()))
    assert T.T.resolve().uplo.name == J.T.resolve().uplo.name


def test_unit_triangular_and_transpose_flags(rng):
    a = rng.standard_normal((40, 40)).astype(np.float32)
    J = jst.TriangularMatrix(jst.Uplo.Lower, a, mb=16,
                             diag=jst.Diag.Unit)
    T = st.TriangularMatrix(st.Uplo.Lower, a, mb=16, diag=st.Diag.Unit,
                            device="cpu")
    assert np.array_equal(T.to_numpy(), np.asarray(J.to_dense()))
    assert T.T.op is st.Op.Trans and T.T.T.op is st.Op.NoTrans
    assert T.H.op is st.Op.ConjTrans and T.shape == J.shape


@pytest.mark.parametrize("m,n,mp,np_", [(50, 50, 64, 64), (50, 30, 64, 32),
                                        (64, 64, 64, 64), (10, 60, 16, 64)])
def test_pad_diag_identity_matches_jax(rng, m, n, mp, np_):
    a = np.zeros((mp, np_), np.float32)
    a[:m, :n] = rng.standard_normal((m, n))
    ref = np.asarray(jtiles.pad_diag_identity(jnp.asarray(a), m, n))
    t = torch.as_tensor(a)
    out = ttiles.pad_diag_identity(t, m, n)
    assert np.array_equal(_np(out), ref)
    assert np.array_equal(_np(t), a)            # input never written


def test_zeros_and_tiles(rng):
    Z = st.Matrix(m=20, n=33, mb=8, device="cpu", dtype=torch.float64)
    assert Z.data.shape == (24, 40) and Z.dtype == torch.float64
    a = rng.standard_normal((20, 20)).astype(np.float32)
    T = st.Matrix(a, mb=8, device="cpu")
    assert np.array_equal(_np(T.tile(1, 2)), _np(T.data[8:16, 16:24]))
    assert (T.tileMb(2), T.tileNb(0)) == (4, 8)


# -- devices --------------------------------------------------------------

def test_entry_point_without_device_raises_without_cuda(rng, monkeypatch):
    """No silent CPU fall back: with no card, an entry point given no
    device raises; device="cpu" is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.Matrix(a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.TiledMatrix.zeros(8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.from_jax_state({"data": a}, {"m": 8, "n": 8, "mb": 8, "nb": 8})
    assert st.Matrix(a, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    """The package and chip_smoke.py import neither jax, ml_dtypes nor
    slate_tpu (checked in a fresh interpreter)."""
    code = (
        "import sys, importlib.util\n"
        "import slate_tpu_torch, slate_tpu_torch.testing\n"
        "import slate_tpu_torch.ops.kernels, slate_tpu_torch.ops._build\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'slate_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax():
    """Lazy imports inside functions do not show in sys.modules: scan
    the sources too, the chip scripts' with them."""
    import ast
    files = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "chip_compare.py", "chip_gen_band.py",
        "chip_eigh_leaves.py")]
    for root, _, names in os.walk(os.path.join(REPO, "slate_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "ml_dtypes",
                                   "slate_tpu"), \
                    (path, mod)


def test_tf32_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_bf16_reduced_precision_reduction_off_at_import():
    # bf16 products accumulate in f32, as the reference's HIGHEST
    assert torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction is False


# -- options, tune, methods ----------------------------------------------

def test_options_match_jax():
    from slate_tpu.core import options as jopt
    from slate_tpu_torch.core import options as topt
    assert {k.name: v for k, v in topt._DEFAULTS.items()
            if k is not st.Option.Target} == \
        {k.name: v for k, v in jopt._DEFAULTS.items()
         if k is not jst.Option.Target}
    assert {s: k.name for s, k in topt._STR_ALIASES.items()} == \
        {s: k.name for s, k in jopt._STR_ALIASES.items()}
    opts = {"nb": 96}
    assert topt.get_option(opts, st.Option.BlockSize) == 96
    assert topt.has_option(opts, st.Option.BlockSize)
    assert topt.get_option(None, st.Option.Lookahead) == 1


def test_frozen_table_copied_row_for_row():
    assert tcache.FROZEN == jcache.FROZEN


def test_tune_env_isolated_from_jax(tune_env, monkeypatch, tmp_path):
    """The port reads only its own variables: the JAX cache directory
    and switch do not move it, and vice versa."""
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("SLATE_TPU_TUNE", "0")
    assert tcache.cache_dir() == str(tune_env)
    assert tcache.enabled()
    assert jcache.cache_dir() == str(tmp_path / "jax")
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE", "0")
    assert not tcache.enabled()


def test_tune_cache_put_save_resolve(tune_env):
    assert tcache._backend_device() == ("cpu", "cpu")
    assert tcache.make_key("lu_panel", torch.float32, 300) == \
        "lu_panel|cpu|cpu|float32|512"
    assert tcache.make_key("lu_panel", np.float32, 300) == \
        tcache.make_key("lu_panel", torch.float32, 300)
    c = tcache.get_cache()
    c.put("lu_panel", torch.float32, 512,
          {"method_lu_panel": "pallas_rec"})
    path = c.save()
    tcache.reset_cache()
    assert tcache.TuneCache._parse(path)
    assert MethodLUPanel.resolve(512, 128, torch.float32) \
        is MethodLUPanel.PallasRec
    # other buckets and dtypes stay cold
    assert MethodLUPanel.resolve(2048, 128, torch.float32) \
        is MethodLUPanel.Native
    assert MethodLUPanel.resolve(512, 128, torch.bfloat16) \
        is MethodLUPanel.Fori
    with tselect.disabled():
        assert MethodLUPanel.resolve(512, 128, torch.float32) \
            is MethodLUPanel.Native
    # explicit options beat the cache; frozen rows serve the rest
    c.put("getrf", torch.float32, 512, {"nb": 64})
    assert tselect.tuned_int("getrf", "nb", 256, n=512,
                             dtype=torch.float32) == 64
    assert tselect.tuned_int("getrf", "nb", 256, opts={"nb": 32},
                             option=st.Option.BlockSize, n=512) == 32
    assert tselect.resolve("lu_panel", "ib") == 32


def test_corrupt_cache_is_empty(tune_env):
    with open(tcache.cache_path(), "w") as f:
        f.write("{not json")
    tcache.reset_cache()
    assert tcache.get_cache().lookup("lu_panel", torch.float32, 512) is None


@pytest.mark.parametrize("m,w,dtype", [(256, 64, "float32"),
                                       (256, 64, "bfloat16"),
                                       (256, 64, "float64")])
def test_cold_panel_route_matches_jax(tune_env, m, w, dtype):
    """A cold cache routes as the reference does on the CPU: native
    where the library LU takes the dtype, else the fori loop."""
    from slate_tpu.core.methods import MethodLUPanel as JMethod
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    assert MethodLUPanel.cold_default(m, w, tdt).name == \
        JMethod.cold_default(m, w, jdt).name


# -- obs ------------------------------------------------------------------

def test_instrumented_driver_publishes_when_enabled(rng):
    from slate_tpu_torch.obs import events as ev
    from slate_tpu_torch.testing import permuted_boosted_system
    a, b = permuted_boosted_system(rng, 64, 2)
    A = st.Matrix(a, mb=32, device="cpu")
    B = st.Matrix(b, mb=32, device="cpu")
    ev.clear()
    st.gesv(A, B)
    assert ev.events() == []                   # off by default
    ev.enable()
    try:
        tm = st.Timers()
        st.gesv(A, B, {st.Option.Timers: tm})
        names = [e.name for e in ev.events(cat="driver")]
        assert names.count("gesv") == 1 and names.count("getrf") == 1
        assert {"gesv::getrf", "gesv::getrs"} <= set(tm.values)
    finally:
        ev.disable()
        ev.clear()
