"""The port's dense decoder ``LM`` against the reference ``LM`` on the CPU,
in fp32, with the reference's weights bridged by ``from_jax_lm_params``:
prefill logits, eight decode steps' logits and every layer's cache agree
within 1e-5, for llama3-8b.reduced() (a stack of four global layers) and
for gemma3-1b.reduced() at six layers (five local layers with a 32-token
window and their ring caches, one global layer), with prompts longer than
the window so the rings wrap. Plus the unported layer kinds raise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rc  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.models import attention, blocks  # noqa: E402
from repro_torch.models.lm import LM, build_program  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, init_params,
                                       layers_of_segments)

TOL = dict(atol=1e-5, rtol=1e-5)


def cfgs(arch, **kw):
    ref = dataclasses.replace(rc.get_config(arch).reduced(), dtype="float32",
                              **kw)
    port = dataclasses.replace(tc.get_config(arch).reduced(),
                               dtype="float32", **kw)
    return ref, port


CASES = {"llama3-8b": {}, "gemma3-1b": {"num_layers": 6}}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_prefill_and_decode_match_reference(arch):
    ref_cfg, cfg = cfgs(arch, **CASES[arch])
    ref_lm, lm = RefLM(ref_cfg), LM(cfg)
    assert [s.pattern for s in lm.program] == [
        tuple(blocks.LayerSpec(*dataclasses.astuple(sp)) for sp in s.pattern)
        for s in ref_lm.program]
    ref_params = ref_lm.init(jax.random.PRNGKey(1))
    params = from_jax_lm_params(ref_params, cfg, "cpu")
    rng = np.random.default_rng(5)
    B, S, steps = 2, 40, 8
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    cap = S + steps + 1
    if cfg.attn.sliding_window:
        assert S > cfg.attn.sliding_window   # the ring caches wrap

    want, ref_caches = jax.jit(ref_lm.prefill, static_argnums=2)(
        ref_params, {"tokens": jnp.asarray(toks[:, :S])}, cap)
    got, caches = lm.prefill(params,
                             {"tokens": torch.from_numpy(toks[:, :S]).long()},
                             cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    check_caches(ref_lm, ref_caches, caches, cfg, cap)

    ref_step = jax.jit(ref_lm.decode_step)
    for i in range(steps):
        want, ref_caches = ref_step(
            ref_params, ref_caches,
            {"token": jnp.asarray(toks[:, S + i]),
             "cache_len": jnp.asarray(S + i, jnp.int32)})
        got, caches = lm.decode_step(
            params, caches, {"token": torch.from_numpy(toks[:, S + i]).long(),
                             "cache_len": S + i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode step {i}")
    check_caches(ref_lm, ref_caches, caches, cfg, cap)


def check_caches(ref_lm, ref_caches, caches, cfg, cap):
    """Same layout (full caches left-aligned at capacity, local layers a
    ring of ``sliding_window`` slots) and the same values within 1e-5."""
    ref_layers = layers_of_segments(ref_lm.program, ref_caches)
    assert len(ref_layers) == len(caches) == cfg.num_layers
    for i, (rl, pl) in enumerate(zip(ref_layers, caches)):
        assert sorted(rl) == sorted(pl) == ["k", "v"]
        for k in ("k", "v"):
            want = np.asarray(rl[k])
            w = blocks.window_cache_size(cfg, blocks.make_layer_spec(cfg, i),
                                         cap)
            assert pl[k].shape == want.shape == (
                2, w or cap, cfg.num_kv_heads, cfg.head_dim)
            np.testing.assert_allclose(pl[k].numpy(), want, **TOL,
                                       err_msg=f"layer {i} {k}")


def test_program_and_weight_tree():
    """gemma3's six layers are one sextet (five local, one global); the
    bridged tree is per layer in execution order; init_lm_params draws the
    paged runner's weights for the same generator seed."""
    _, cfg = cfgs("gemma3-1b", num_layers=6)
    prog = build_program(cfg)
    assert [(len(s.pattern), s.repeat) for s in prog] == [(6, 1)]
    assert [sp.is_global for sp in prog[0].pattern] == [False] * 5 + [True]
    _, llama = cfgs("llama3-8b")
    assert [(len(s.pattern), s.repeat) for s in build_program(llama)] == [
        (1, 4)]
    a = init_lm_params(llama, torch.Generator().manual_seed(3), "cpu")
    b = init_params(llama, torch.Generator().manual_seed(3), "cpu",
                    torch.float32)
    assert len(a["layers"]) == 4 and sorted(a["head"]) == sorted(b["head"])
    for la, lb in zip(a["layers"] + [a["head"]], b["layers"] + [b["head"]]):
        assert all(torch.equal(la[k], lb[k]) for k in lb)


def test_decode_attention_and_update_cache_match_reference():
    """The jnp helpers' twins on ragged (B,) bounds, GQA, and a clamped
    cache write."""
    import repro.models.attention as ra
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 3, 24, 4, 2, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vf, vt = np.array([0, 3, 5], np.int32), np.array([24, 10, 6], np.int32)
    want = ra.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(vf), jnp.asarray(vt))
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), torch.from_numpy(vf),
                                     torch.from_numpy(vt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    new = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
    for pos in (0, 7, S - 1, S + 5):
        want = ra.update_cache(jnp.asarray(k), jnp.asarray(new), pos)
        got = attention.update_cache(torch.from_numpy(k.copy()),
                                     torch.from_numpy(new), pos)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,item", [("mamba2-2.7b", "item 8"),
                                       ("mixtral-8x7b", "item 8"),
                                       ("seamless-m4t-medium", "item 7d"),
                                       ("paligemma-3b", "item 7d")])
def test_unported_layer_kinds_raise(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        LM(tc.get_config(arch).reduced())
