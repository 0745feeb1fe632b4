"""The port's ``LM`` against the reference ``LM`` on the CPU for every
config of the repo that has no MoE layer (dense stacks, sliding windows,
a frontend, an encoder-decoder, the SSM-only mamba2), reduced, in fp32,
within 1e-5 (``torch_parity.check_lm_parity``); the MoE configs and jamba
are in ``test_torch_models_moe.py``. Plus: ``LM`` constructs for all 13
full configs, ``make_demo_inputs``/``batch_specs`` equal the reference's,
and the reference's prefill/decode continuity test, ported for the port
alone."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rc  # noqa: E402
from repro.models import api as ref_api  # noqa: E402

from torch_parity import ALL_IDS, MOE_IDS, check_lm_parity  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import init_lm_params  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", [a for a in ALL_IDS if a not in MOE_IDS])
def test_prefill_decode_and_caches_match_reference(arch):
    check_lm_parity(arch)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_lm_constructs_every_config_at_full_size(arch):
    cfg = tc.get_config(arch)
    lm = LM(cfg)
    assert len(lm.specs) == cfg.num_layers
    assert len(lm.enc_specs) == cfg.num_encoder_layers
    assert sum(sp.mixer == "attn" for sp in lm.specs) == cfg.num_attn_layers


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["paligemma-3b", "seamless-m4t-medium",
                                  "llama3-8b"])
def test_batch_specs_and_demo_inputs_match_reference(arch, kind):
    ref_cfg = rc.get_config(arch).reduced()
    cfg = tc.get_config(arch).reduced()
    want = ref_api.batch_specs(ref_cfg, rc.ShapeConfig("s", 24, 2, kind))
    got = api.batch_specs(cfg, tc.ShapeConfig("s", 24, 2, kind))
    assert {k: (s.shape, s.dtype) for k, s in got.items()} == {
        k: (s.shape, s.dtype) for k, s in want.items()}
    ref_in = ref_api.make_demo_inputs(ref_cfg, rc.ShapeConfig("s", 24, 2,
                                                              kind))
    got_in = api.make_demo_inputs(cfg, tc.ShapeConfig("s", 24, 2, kind))
    assert list(got_in) == list(ref_in)
    for k, v in ref_in.items():
        g = got_in[k]
        g = np.asarray(g) if isinstance(g, int) else g.float().numpy()
        np.testing.assert_array_equal(g, np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_recommended_microbatches_match_reference(arch):
    assert api.recommended_microbatches(tc.get_config(arch)) == \
        ref_api.recommended_microbatches(rc.get_config(arch))


@pytest.mark.parametrize("arch", ["yi-34b", "gemma3-1b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium",
                                  "qwen3-moe-30b-a3b", "paligemma-3b"])
def test_prefill_decode_continuity(arch):
    """decode(prefill(t[:n])) equals prefill(t[:n+1])'s last logits, on the
    port alone (``tests/test_models.py``'s test, same configs, inputs and
    tolerance; MoE at capacity_factor = num_experts, so nothing drops)."""
    cfg = dataclasses.replace(tc.get_config(arch).reduced(), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    lm = LM(cfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))).long()
    F = cfg.frontend.num_embeds if (cfg.frontend.kind != "none"
                                    and not cfg.num_encoder_layers) else 0
    extra = {}
    if cfg.frontend.kind != "none":
        extra["src_embeds" if cfg.num_encoder_layers else "embeds"] = \
            torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend.num_embeds, cfg.frontend.embed_dim))).float()
    cap = 40 + F + 4
    _, caches = lm.prefill(params, {"tokens": toks[:, :39], **extra}, cap)
    got, _ = lm.decode_step(params, caches, {"token": toks[:, 39],
                                             "cache_len": 39 + F})
    want, _ = lm.prefill(params, {"tokens": toks, **extra}, cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-4,
                               rtol=1e-3)
