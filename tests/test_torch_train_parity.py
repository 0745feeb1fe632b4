"""The port's training objective against the reference's on the CPU, for
the dense stacks: ``LM.train_loss`` and its ``.backward()`` (remat on,
attention through the flash ``autograd.Function``) against
``jax.value_and_grad(lm.train_loss)``, reduced, in fp32, on bridged
weights and each package's demo inputs (``torch_parity.
check_train_parity``: loss within 1e-5 relative, every gradient within
atol 1e-5, rtol 1e-4). llama3-8b (GQA), gemma3-1b at 6 layers over 40
positions (five 32-token windows and a global layer), paligemma-3b (a
frontend's embeddings before the tokens) and seamless-m4t-medium (an
encoder and cross-attention); the MoE, SSM and hybrid families are in
``test_torch_train_parity_families.py``."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_train_parity  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,S", [("llama3-8b", 32), ("gemma3-1b", 40),
                                    ("paligemma-3b", 32),
                                    ("seamless-m4t-medium", 32)])
def test_train_loss_and_grads_match_reference(arch, S):
    check_train_parity(arch, S)


def test_train_loss_without_remat_matches_reference():
    check_train_parity("llama3-8b", 32, remat=False)
