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
