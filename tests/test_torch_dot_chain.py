"""The port's dot chain against the JAX rate probe `tools/mxu_rate_probe.py`.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs the
tool's `make_pallas_chain` in TPU interpret mode and its `make_xla_chain`,
unedited, on the same numpy inputs.  The CUDA kernel (csrc/dot_chain.cu) is
held to the plain version on the card by chip_smoke.py, with these bars:

  - int8: equal bit for bit.  The products are exact integers, and the
    narrowing keeps the low byte, which wraps: the independent sums leave
    int8's range, and so does the chained step's floor(d / 4096) on a row
    built to (random rows in [-80, 80) stay near +-24).
  - f32: max |diff| <= 5e-5 of the output's peak: the same f32 products
    summed in another order, up to 128 * n_dots terms each rounded at
    6e-8 relative.
  - bf16, one dot: within one bf16 ulp of each element (a reordered f32 sum
    can move the final rounding by one step).  More dots: relative L2
    <= 1e-3 for the independent sum and <= 3e-4 per dot for the chain,
    since a one-ulp flip (3.9e-3 relative) at one step is carried into the
    next dot's sum.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audiodec_tpu_torch.bin import mxu_rate_probe
from audiodec_tpu_torch.ops.kernels import dot_chain as port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROWS, TILES = 16, 2
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8),
          "float32": (jnp.float32, torch.float32)}
F32_REL, BF16_RL2, BF16_RL2_PER_DOT = 5e-5, 1e-3, 3e-4


@functools.cache
def _tool():
    """tools/mxu_rate_probe.py as a module.  It sets JAX's compilation
    cache options when imported; they are put back as they were."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "mxu_rate_probe_tool", ROOT / "tools" / "mxu_rate_probe.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _inputs(dtype: str, n_dots: int, seed: int = 0):
    """The tool's input recipe, numpy."""
    rng = np.random.default_rng(seed)
    m = ROWS * TILES
    if dtype == "int8":
        return (rng.integers(-80, 80, (m, 128)).astype(np.int8),
                rng.integers(-80, 80, (n_dots, 128, 128)).astype(np.int8))
    return (rng.standard_normal((m, 128)).astype(np.float32),
            (rng.standard_normal((n_dots, 128, 128)) * 0.09)
            .astype(np.float32))


def _jax(make, dtype: str, x, w, independent: bool):
    jdt = DTYPES[dtype][0]
    f = make(ROWS, w.shape[0], TILES, jdt, independent=independent)
    with pltpu.force_tpu_interpret_mode():
        y = f(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    return np.asarray(y.astype(jnp.float32))


def _port(dtype: str, x, w, independent: bool, fn=port.dot_chain):
    tdt = DTYPES[dtype][1]
    out = fn(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
             independent)
    assert out.dtype == tdt and out.shape == x.shape
    return out.float().numpy()


def _assert_bar(dtype: str, out, ref, n_dots: int, independent: bool):
    if dtype == "int8":
        np.testing.assert_array_equal(out, ref)
    elif dtype == "float32":
        assert np.abs(out - ref).max() <= F32_REL * np.abs(ref).max()
    else:
        rl2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        bar = BF16_RL2 if independent else BF16_RL2_PER_DOT * n_dots
        assert rl2 <= bar, rl2


MODES = [False, True]
CASES = [(d, m) for d in DTYPES for m in MODES]


@pytest.mark.parametrize("dtype,independent", CASES)
def test_port_matches_pallas_kernel(dtype, independent):
    x, w = _inputs(dtype, 3)
    ref = _jax(_tool().make_pallas_chain, dtype, x, w, independent)
    _assert_bar(dtype, _port(dtype, x, w, independent), ref, 3,
                independent)


@pytest.mark.parametrize("dtype,independent", CASES)
def test_port_matches_xla_chain(dtype, independent):
    x, w = _inputs(dtype, 3)
    ref = _jax(_tool().make_xla_chain, dtype, x, w, independent)
    _assert_bar(dtype, _port(dtype, x, w, independent), ref, 3,
                independent)


@pytest.mark.parametrize("independent", MODES)
def test_bf16_one_dot_within_one_ulp(independent):
    x, w = _inputs("bfloat16", 1, seed=1)
    ref = _jax(_tool().make_pallas_chain, "bfloat16", x, w, independent)
    out = _port("bfloat16", x, w, independent)
    # one bf16 ulp at |ref|: 2^(exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(out - ref) <= ulp).all()


@pytest.mark.parametrize("independent", MODES)
def test_int8_chain_wraps(independent):
    """Narrowing to int8 keeps the low byte.  Chained: a row of 79s against
    a column of 79s gives d = 128 * 79^2 and d // 4096 = 195, which wraps
    to -61 (random rows stay near +-24).  Independent: the int32 sum of
    the products leaves int8's range on most elements."""
    x, w = _inputs("int8", 3, seed=2)
    x[0], w[0, :, 0] = 79, 79
    d = x.astype(np.int64) @ w[0].astype(np.int64)
    if independent:
        wide = d + sum(x.astype(np.int64) @ w[i].astype(np.int64)
                       for i in (1, 2))
    else:
        wide = d // 4096
        assert wide[0, 0] == 195
    assert (np.abs(wide) > 127).any()
    ref = _jax(_tool().make_pallas_chain, "int8", x, w, independent)
    np.testing.assert_array_equal(_port("int8", x, w, independent), ref)
    if independent:
        np.testing.assert_array_equal(ref, wide.astype(np.int8))


@pytest.mark.parametrize("dtype,independent", CASES)
def test_library_chain_matches_plain(dtype, independent):
    x, w = _inputs(dtype, 3, seed=3)
    ref = _port(dtype, x, w, independent, port.dot_chain_plain)
    out = _port(dtype, x, w, independent, port.dot_chain_library)
    if dtype == "bfloat16" and independent:
        # the library chain rounds each product to bf16 before its f32 sum
        # (one PyTorch call per dot), so it differs by about one bf16
        # rounding (2^-9 relative) per product
        rl2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        assert rl2 <= 1e-2, rl2
    else:
        _assert_bar(dtype, out, ref, 3, independent)


def test_probe_main_on_cpu():
    records = mxu_rate_probe.main(["--device", "cpu", "--rows", "16",
                                   "--dots", "2", "--tiles", "2"])
    assert len(records) == 12
    assert {(r["impl"], r["dtype"], r["mode"]) for r in records} == {
        (i, d, m) for i in ("kernel", "torch")
        for d in ("bfloat16", "int8", "float32")
        for m in ("chained", "independent")}
    assert all(r["device"] == "cpu" and r["ms"] > 0 and r["bound_ms"] > 0
               for r in records)


@pytest.mark.parametrize("x,w,exc", [
    (torch.zeros(4, 128), torch.zeros(2, 128, 128, dtype=torch.bfloat16),
     TypeError),
    (torch.zeros(4, 64), torch.zeros(2, 64, 64), ValueError),
    (torch.zeros(4, 128, device="meta"), torch.zeros(2, 128, 128,
                                                      device="meta"),
     ValueError),
])
def test_bad_calls_raise(x, w, exc):
    with pytest.raises(exc):
        port.dot_chain(x, w)
    assert port.launches == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_wgmma_pack_is_a_permutation(dtype):
    """csrc/dot_chain.cu's wgmma reads B from the pack: unpacking gives w
    back, the bytes are w's permuted, and byte (n, k) of w[i] sits at the
    swizzled address the kernel's descriptor reads (atom k // 128 bytes,
    row n, 16-byte chunk XORed with n % 8)."""
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(3, 128, 128, generator=gen) * 40).to(dtype)
    packed = port.wgmma_pack(w)
    size = w.element_size()
    assert packed.dtype == torch.uint8
    assert packed.shape == (3, 128 * 128 * size)
    assert torch.equal(port.wgmma_unpack(packed, dtype), w)
    raw = w.contiguous().view(torch.uint8).reshape(3, -1)
    assert torch.equal(packed.sort(dim=1).values, raw.sort(dim=1).values)
    nk = w.transpose(1, 2).contiguous().view(torch.uint8)  # [i][n][k bytes]
    for i, n, kb in ((0, 0, 0), (1, 9, 70 * size), (2, 127, 128 * size - 1)):
        atom, byte = divmod(kb, 128)
        addr = (atom * 128 * 128 + n * 128
                + (((byte // 16) ^ (n % 8)) * 16) + byte % 16)
        assert packed[i, addr] == nk[i, n, kb]


def test_wgmma_pack_is_cached_until_changed():
    w = torch.ones(2, 128, 128, dtype=torch.bfloat16)
    first = port.packed_weights(w)
    assert port.packed_weights(w) is first
    w[1, 3, 5] = 2.0  # an in-place update must repack
    again = port.packed_weights(w)
    assert again is not first
    assert torch.equal(port.wgmma_unpack(again, torch.bfloat16), w)
