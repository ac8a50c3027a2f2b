"""The port's `pipelined_map` (controlvar_tpu_torch/eval/serving.py): the
cases of tests/test_serving.py on torch tensors (ordering, nests of
results, laziness, the in-flight bound, the depth check), and the JAX and
port functions yielding the same (item, result) sequence for the same
numpy inputs."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlvar_tpu.eval.serving import pipelined_map as jax_pipelined_map

from controlvar_tpu_torch.eval.serving import pipelined_map

from tests.torch_fixtures import one_torch_thread  # noqa: F401


def test_results_in_submission_order_and_equal_sequential():
    f = lambda x: x * 2 + 1
    items = [torch.full((4,), float(i)) for i in range(7)]
    got = list(pipelined_map(f, items, depth=3))
    assert len(got) == 7
    for i, (item, out) in enumerate(got):
        np.testing.assert_array_equal(item.numpy(), np.full((4,), i))
        np.testing.assert_array_equal(out.numpy(), np.full((4,), 2 * i + 1))


def test_nested_results_and_depth_one():
    f = lambda x: (x + 1, {"sq": x * x, "l": [x, -x]})
    items = [torch.tensor(float(i)) for i in range(4)]
    outs = [o for _, o in pipelined_map(f, items, depth=1)]
    assert float(outs[2][0]) == 3.0
    assert float(outs[3][1]["sq"]) == 9.0
    assert float(outs[3][1]["l"][1]) == -3.0


def test_items_consumed_lazily():
    """At most `depth` items are in flight: dispatch of item depth+i waits
    until item i was yielded."""
    drawn = []

    def items():
        for i in range(10):
            drawn.append(i)
            yield torch.tensor(float(i))

    gen = pipelined_map(lambda x: x + 1, items(), depth=2)
    next(gen)  # the first yield happens once the window is full
    assert len(drawn) <= 3  # 2 in flight + the one being appended
    list(gen)
    assert len(drawn) == 10


def test_in_flight_never_exceeds_depth():
    for depth in (1, 2, 3):
        dispatched, yielded, peak = [0], [0], [0]

        def fn(x):
            dispatched[0] += 1
            peak[0] = max(peak[0], dispatched[0] - yielded[0])
            return torch.tensor(float(x))

        for _ in pipelined_map(fn, list(range(8)), depth=depth):
            yielded[0] += 1
        assert yielded[0] == 8
        assert peak[0] <= depth


def test_depth_validation():
    with pytest.raises(ValueError):
        list(pipelined_map(lambda x: x, [torch.zeros(())], depth=0))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_same_sequence_as_the_jax_function(depth):
    """The same numpy items through both functions: the same items in the
    same order, and results equal (the port's in float64 like numpy's)."""
    rng = np.random.default_rng(depth)
    items = [rng.standard_normal((3, 5)) for _ in range(6)]
    got = list(pipelined_map(lambda a: (torch.from_numpy(a) * 3 - 1, torch.from_numpy(a).sum()),
                             items, depth=depth))
    want = list(jax_pipelined_map(lambda a: (jnp.asarray(a) * 3 - 1, jnp.asarray(a).sum()),
                                  items, depth=depth))
    assert len(got) == len(want) == 6
    for (gi, (g0, g1)), (wi, (w0, w1)) in zip(got, want):
        assert gi is wi
        np.testing.assert_allclose(g0.numpy(), np.asarray(w0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(g1), float(w1), rtol=1e-5, atol=1e-5)


def test_plain_cpu_results_get_no_event():
    """CPU results are yielded without a CUDA event (there is no card here
    and none is needed)."""
    from controlvar_tpu_torch.eval import serving

    assert serving._done_event((torch.zeros(2), {"a": [torch.ones(1)]}, 3)) is None
