"""The port's probes (ops/probes.py) against the JAX probes of
scripts/prof_pallas.py: the plain versions against the math the JAX probes
check themselves against, on the same seeded inputs, and the JAX probes
themselves in Pallas interpret mode.  The kernels (K7-K9) are held against
the plain versions on the card in tests/test_torch_kernels.py, the probe
entry point's tools in tests/test_torch_prof_tools.py."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linr_pcgc_tpu_torch.ops import probes

from jax_reference import fast_jax_compiles  # noqa: F401  (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scale_shift_plain_is_exact():
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32) * 1e3
    x[0, :128] = np.arange(128, dtype=np.float32)  # the JAX probe's arange block
    got = probes.probe_scale_shift_plain(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x) * 2.0 + 1.0))


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (100, 70, 130)])
def test_matmul_plain_within_the_jax_probe_tolerance(m, k, n):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    got = probes.probe_matmul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(a) @ jnp.asarray(b)),
                               rtol=2e-5, atol=2e-4)


def _tf32(x):
    """Round float32 to nearest onto TF32's 10 mantissa bits, ties away
    from zero (cvt.rna.tf32.f32), as csrc/probes.cu's tf32_bits does on the
    bit pattern."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _matmul_3xtf32(a, b, chunk=64, ksplit=2):
    """K8's arithmetic: a and b split into big = tf32(x) and small =
    tf32(x - big).  K runs in chunks of 64 (zero-padded at a ragged k); of
    each chunk's K steps of 8, warp half h takes steps 4h..4h+3.  Per step
    a half's mma adds a_small b_big, then a_big b_small, into its
    correction accumulator and a_big b_big into its main one, each product
    exact (TF32 x TF32 fits float64) and rounded once to float32 as it is
    added.  A half's part is main + correction; the parts are added in
    order."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    shape = (a.shape[0], b.shape[1])
    big = [torch.zeros(shape, dtype=torch.float32) for _ in range(ksplit)]
    corr = [torch.zeros(shape, dtype=torch.float32) for _ in range(ksplit)]

    def add(acc, x, y, k0):
        return (acc.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()).float()

    for k0 in range(0, a.shape[1], 8):
        h = (k0 % chunk) // (chunk // ksplit)
        corr[h] = add(add(corr[h], a_small, b_big, k0), a_big, b_small, k0)
        big[h] = add(big[h], a_big, b_big, k0)
    out = big[0] + corr[0]
    for h in range(1, ksplit):
        out = out + (big[h] + corr[h])
    return out


@pytest.mark.parametrize("m,k,n,scale", [(512, 512, 512, 1.0), (100, 70, 130, 1.0),
                                         (100, 70, 130, 1e3)])
def test_matmul_3xtf32_within_the_jax_probe_tolerance(m, k, n, scale):
    """The numerics of K8 held on the CPU before the card: the emulated
    3xTF32 product is within the JAX probe's tolerance (rtol 2e-5, atol
    2e-4 at unit-scale inputs) of JAX's float32 a @ b.  At inputs scaled
    by 1e3 (products by 1e6) the same tolerance reads atol 2e-4 * 1e6: the
    split must keep f32 accuracy at any exponent."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((m, k)) * scale).astype(np.float32)
    b = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    big = _tf32(torch.as_tensor(a))
    assert bool((big.view(torch.int32) & 0x1FFF == 0).all())
    assert float((torch.as_tensor(a) - big).abs().max()) <= 2.0**-11 * float(np.abs(a).max())
    got = _matmul_3xtf32(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4 * scale**2)


def test_row_gather_plain_is_exact():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    idx = rng.integers(0, 512, 512, dtype=np.int32)
    got = probes.probe_row_gather_plain(torch.as_tensor(x), torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, x[idx])


def test_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((16, 8)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, 16, 5, dtype=np.int32))
    launched = [f.launches for f in (probes.probe_scale_shift, probes.probe_matmul,
                                     probes.probe_row_gather)]
    assert torch.equal(probes.probe_scale_shift(x), probes.probe_scale_shift_plain(x))
    assert torch.equal(probes.probe_matmul(x, x.t().contiguous()),
                       probes.probe_matmul_plain(x, x.t().contiguous()))
    assert torch.equal(probes.probe_row_gather(x, idx), probes.probe_row_gather_plain(x, idx))
    assert [f.launches for f in (probes.probe_scale_shift, probes.probe_matmul,
                                 probes.probe_row_gather)] == launched
    xm, im = x.to("meta"), idx.to("meta")
    for call in (lambda: probes.probe_scale_shift(xm), lambda: probes.probe_matmul(xm, xm.t()),
                 lambda: probes.probe_row_gather(xm, im)):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    with pytest.raises(TypeError):
        probes.probe_row_gather(x, idx.long())


def test_jax_probes_pass_in_interpret_mode():
    """scripts/prof_pallas.py as it runs on a CPU, in a process of its own:
    at import it rebinds pl.pallas_call to interpret mode, which must not
    leak into the JAX package's Pallas tests in this process."""
    env = dict(os.environ, PALLAS_INTERPRET="1", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, os.path.join("scripts", "prof_pallas.py")], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    for line in ("PALLAS BASIC: OK", "PALLAS GRID MATMUL: OK", "PALLAS SCALAR-PREFETCH GATHER: OK"):
        assert line in r.stdout.splitlines(), r.stdout + r.stderr
