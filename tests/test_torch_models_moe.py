"""The port's ``LM`` against the reference ``LM`` on the CPU for the
configs with MoE layers (mixtral-8x7b, dbrx-132b, qwen3-moe-30b-a3b, and
jamba-1.5-large at 8 layers: SSM layers, one attention layer, MoE on odd
layers), reduced, in fp32, within 1e-5 (``torch_parity.check_lm_parity``):
at the default capacity factor, where mixtral, dbrx and qwen3-moe drop
tokens (jamba's reduced routing fills no expert past 1.25x its share on
these inputs, so it is also run at 1.0, where it drops), and at
capacity_factor = num_experts, where nothing drops."""
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rc  # noqa: E402

from torch_parity import MOE_IDS, check_lm_parity  # noqa: E402

JAMBA = "jamba-1.5-large-398b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,capacity", [
    (a, c) for c in ("default", "num_experts") for a in MOE_IDS]
    + [(JAMBA, "1.0")])
def test_prefill_decode_and_caches_match_reference(arch, capacity,
                                                   monkeypatch):
    E = rc.get_config(arch).reduced().moe.num_experts
    cf = {"default": None, "num_experts": float(E), "1.0": 1.0}[capacity]
    drops = check_lm_parity(arch, capacity_factor=cf,
                            monkeypatch=monkeypatch)
    assert drops, "no MoE call was made"
    if capacity == "num_experts" or (arch, capacity) == (JAMBA, "default"):
        assert sum(drops) == 0
    else:
        assert sum(drops) > 0, "nothing was dropped"
