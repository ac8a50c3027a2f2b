"""What the port's tests share.

`one_torch_thread` is a module-scoped autouse fixture: a test module takes
it by importing it,

    from tests.torch_fixtures import one_torch_thread  # noqa: F401

and every test of that module then runs torch on one thread. The suite
runs six workers on the machine's cores, and torch's default pool of one
thread a core in each worker oversubscribes them: every parallel region
then waits for threads that the other workers hold. A (1, 2, 9, 9) x
(1, 2, 9, 8) einsum took 17 ms on eight threads beside six busy workers
and 0.04 ms on one; the port's tests spent about two thirds of their
worker-seconds so. The module's end restores the count, so that the
modules after it in the same worker run as they would alone.

`vq_to_jax` carries a port VQVAE (or loss) tree to the JAX layout as numpy;
`raise_gates` raises a ControlVAR tree's AdaLN gates. Neither imports JAX.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def vq_to_jax(tree):
    """A port tree as numpy in the JAX layout: every "kernel" is a conv
    kernel, OIHW -> HWIO (the inverse of `from_jax_params`); None stays
    None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (v.detach().numpy().transpose(2, 3, 1, 0) if k == "kernel"
                    else vq_to_jax(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [vq_to_jax(v) for v in tree]
    return tree.detach().numpy()


def raise_gates(tree):
    """Raise the attention gate by 10 and the FFN gate by 1, in place, in the
    blocks' ada_lin bias of a ControlVAR or VAR tree, in the JAX layout
    (numpy) or the port's. At init they are 1e-3 of the rest, which leaves
    attention out of the outputs (a cache holding K in place of V would go
    unseen)."""
    bias = tree["blocks"]["ada_lin"]["bias"]
    C = bias.shape[1] // 6
    bias[:, :C] += 10.0
    bias[:, C: 2 * C] += 1.0
    return tree

