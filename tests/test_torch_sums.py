"""Float32 totals in the reference's order: utils/prng.xla_f32_sum against
the compiled `jnp.sum` of XLA's CPU backend, and the two callers whose
inputs are not integers once recombination mixes merits -- the
scheduler's merit total and the .dat averages of `summarize`.

Tolerance: exact -- float32 bit patterns equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from avida_tpu.ops import scheduler as rsched  # noqa: E402
from avida_tpu.ops import update as rupdate  # noqa: E402

from avida_tpu_torch import convert  # noqa: E402
from avida_tpu_torch.ops import scheduler as tsched  # noqa: E402
from avida_tpu_torch.ops import update as tupdate  # noqa: E402
from avida_tpu_torch.utils import prng  # noqa: E402

from test_torch_placement import (both_params, pending_arrays,  # noqa: E402
                                  ref_state)

_masked_sum = jax.jit(lambda a, x: jnp.where(a, x, 0.0).sum())


def _fractional(rng, n):
    """Positive float32 values over six decades: their float32 total
    depends on the order of the adds."""
    return (rng.random(n) * 10.0 ** rng.integers(-3, 3, n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 7, 32, 33, 36, 64, 100, 144, 225, 1000,
                               1025, 4096, 102400])
def test_xla_f32_sum_equals_compiled_sum(n):
    rng = np.random.default_rng(n)
    for _ in range(20 if n < 5000 else 4):
        x = _fractional(rng, n)
        alive = rng.random(n) < 0.8
        want = np.asarray(_masked_sum(jnp.asarray(alive), jnp.asarray(x)))
        got = prng.xla_f32_sum(torch.from_numpy(np.where(alive, x, 0.0)
                                                .astype(np.float32)))
        assert want.tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("n", [36, 64, 400, 40000])
@pytest.mark.parametrize("method", [1, 2])
def test_compute_budgets_from_fractional_merits(n, method):
    """Merit-proportional budgets from merits that are not integers (the
    recombinant offspring of a heads-sex world): the merit total must be
    the reference's float32 total, not the exactly rounded one."""
    rp, tp = both_params(dict(WORLD_X=6, WORLD_Y=6, SLICING_METHOD=method))
    rng = np.random.default_rng(n + 10 * method)
    for seed in range(3):
        alive = rng.random(n) < 0.9
        merit = (100.0 + 300.0 * rng.random(n)).astype(np.float32)
        a = np.asarray(rsched.compute_budgets_from(
            rp, jnp.asarray(alive), jnp.asarray(merit),
            jax.random.key(seed)))
        b = tsched.compute_budgets_from(
            tp, torch.from_numpy(alive), torch.from_numpy(merit),
            prng.key(seed)).numpy()
        assert a.dtype == b.dtype and (a == b).all(), seed


@pytest.mark.parametrize("side", [6, 13])
def test_summarize_fractional_averages(side):
    """The .dat averages over fractional merits and fitnesses equal the
    reference's compiled summarize, float32 for float32."""
    rp, tp = both_params(dict(WORLD_X=side, WORLD_Y=side, RANDOM_SEED=4,
                              TPU_MAX_MEMORY=64))
    for seed in range(3):
        arrays = pending_arrays(tp, seed=seed, alive_p=0.9)
        want = rupdate.summarize(rp, ref_state(arrays), jnp.int32(5))
        got = tupdate.summarize(tp, convert.state_from_arrays(arrays), 5)
        for k in ("ave_merit", "ave_fitness", "ave_repro_rate",
                  "ave_genome_len", "ave_generation"):
            a = np.asarray(want[k], np.float32)
            assert a.tobytes() == got[k].numpy().tobytes(), (seed, k)


def _big_grants(rng, n):
    """Granted budgets whose float32 total passes 2**24 (uncapped grants
    at bench scale): a heavy tail over a few hundred cycles."""
    lo = 2**24 // n + 20
    g = rng.integers(lo, 3 * lo, n) + (rng.random(n) < 0.01) * rng.integers(
        1000, 20000, n)
    return g.astype(np.int32)


@pytest.mark.parametrize("n,block", [(102400, 512), (40000, 128),
                                     (65536, 256)])
def test_scheduler_totals_past_2_24_equal_reference(n, block):
    """block_ceiling and block_utilization (the lane permutation's
    early-refresh statistic) on granted vectors whose totals pass
    16,777,216, where float32 totals round by summation order: equal to
    the reference's compiled functions."""
    rng = np.random.default_rng(n + block)
    for _ in range(3):
        g = _big_grants(rng, n)
        assert g.astype(np.float64).sum() > 2**24
        want_c = np.asarray(jax.jit(rsched.block_ceiling,
                                    static_argnums=1)(jnp.asarray(g), block))
        want_u = np.asarray(jax.jit(rsched.block_utilization,
                                    static_argnums=1)(jnp.asarray(g), block))
        gt = torch.from_numpy(g)
        assert want_c.tobytes() == tsched.block_ceiling(
            gt, block).numpy().tobytes()
        assert want_u.tobytes() == tsched.block_utilization(
            gt, block).numpy().tobytes()


def test_integrated_slicing_remainder_past_2_24_equals_reference():
    """SLICING_METHOD 2 with an update size past 2**24 (AVE_TIME_SLICE
    200 over 102,400 organisms): the remainder handed out by largest
    fraction comes from a float32 total of the floored shares, whose
    rounding depends on the order; the budgets equal the reference's."""
    rp, tp = both_params(dict(WORLD_X=320, WORLD_Y=320, SLICING_METHOD=2,
                              AVE_TIME_SLICE=200))
    rng = np.random.default_rng(24)
    n = 320 * 320
    for seed in range(2):
        alive = rng.random(n) < 0.98
        merit = (50.0 + 400.0 * rng.random(n)).astype(np.float32)
        a = np.asarray(jax.jit(lambda al, m, k: rsched.compute_budgets_from(
            rp, al, m, k))(jnp.asarray(alive), jnp.asarray(merit),
                           jax.random.key(seed)))
        b = tsched.compute_budgets_from(
            tp, torch.from_numpy(alive), torch.from_numpy(merit),
            prng.key(seed)).numpy()
        assert 200 * alive.sum() > 2**24
        assert a.dtype == b.dtype and (a == b).all(), seed
