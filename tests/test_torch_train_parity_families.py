"""The port's training objective against the reference's on the CPU, for
the MoE, SSM and hybrid families (``torch_parity.check_train_parity``:
loss within 1e-5 relative, every gradient within atol 1e-5, rtol 1e-4):
qwen3-moe-30b-a3b (static-capacity dispatch, whose token scatter is an
in-place write on the autograd path), mamba2-2.7b (SSD over two chunks)
and jamba-1.5-large at 8 layers (SSM, attention and MoE)."""
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


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_train_loss_and_grads_match_reference(arch):
    check_train_parity(arch)
