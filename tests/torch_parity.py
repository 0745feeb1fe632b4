"""Helpers of the port's LM parity tests (``tests/test_torch_models*.py``,
``tests/test_torch_train_parity*.py``): one reduced config through the
reference ``LM`` and the port's ``LM`` from the same weights (bridged by
``from_jax_lm_params``) and the same inputs (each package's
``make_demo_inputs``). In fp32 within 1e-5: prefill logits, eight decode
steps' logits and every layer's cache; or the train loss and every
gradient. In bf16 within flash's bf16 tolerance: the logits."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as rc
from repro.models.api import make_demo_inputs as ref_demo_inputs
from repro.models.lm import LM as RefLM

import repro_torch.configs as tc
from repro_torch.models import moe
from repro_torch.models.api import make_demo_inputs
from repro_torch.models.lm import LM
from repro_torch.models.params import from_jax_lm_params, layers_of_segments
from repro_torch.tree import flatten, tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
# reduced() keeps min(n, 4) layers; jamba's attention layer is layer 4 of
# its period of 8 (MoE on odd layers), gemma3's global layer the 6th
LAYERS = {"jamba-1.5-large-398b": 8, "gemma3-1b": 6}
ALL_IDS = tuple(rc.ARCH_IDS) + tuple(rc.PAPER_MODEL_IDS)
MOE_IDS = tuple(a for a in ALL_IDS if rc.get_config(a).moe is not None)


def cfgs(arch, capacity_factor=None, dtype="float32"):
    """(reference config, port config): reduced, in ``dtype`` (fp32 by
    default), at the test's depth, optionally another MoE capacity
    factor."""
    out = []
    for mod in (rc, tc):
        cfg = mod.get_config(arch).reduced()
        kw = {"dtype": dtype}
        if arch in LAYERS:
            kw["num_layers"] = LAYERS[arch]
        if capacity_factor is not None:
            kw["moe"] = dataclasses.replace(cfg.moe,
                                            capacity_factor=capacity_factor)
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


# XLA keeps some bf16 intermediates of a compiled function in fp32 unless
# told not to; compiled without that, the reference rounds where its code
# casts, which is what the port mirrors
EXACT_CASTS = {"xla_allow_excess_precision": False}


def ref_jit(fn, *args, static_argnums=()):
    """``fn`` compiled for ``args`` at the reference code's cast points;
    called like ``fn`` with arguments of the same shapes."""
    compiled = jax.jit(fn, static_argnums=static_argnums).lower(
        *args).compile(compiler_options=EXACT_CASTS)
    if not static_argnums:
        return compiled
    return lambda *a: compiled(*(x for i, x in enumerate(a)
                                 if i not in static_argnums))


def frontend_len(cfg):
    return (cfg.frontend.num_embeds if cfg.frontend.kind != "none"
            and not cfg.num_encoder_layers else 0)


def check_lm_parity(arch, capacity_factor=None, S=40, steps=8,
                    monkeypatch=None, dtype="float32", tol=TOL):
    """Run one config through both packages and assert agreement within
    ``tol``. The prompt (S positions, a frontend's embeddings included) is
    longer than the reduced window (32) and not a multiple of the SSM chunk
    (16). Returns the port's MoE drop counts per call (prefill calls
    first)."""
    ref_cfg, cfg = cfgs(arch, capacity_factor, dtype)
    ref_lm, lm = RefLM(ref_cfg), LM(cfg)
    assert [[dataclasses.astuple(sp) for sp in s.pattern] for s in
            lm.program + lm.enc_program] == [
        [dataclasses.astuple(sp) for sp in s.pattern]
        for s in ref_lm.program + ref_lm.enc_program]
    ref_params = ref_lm.init(jax.random.PRNGKey(1))
    params = from_jax_lm_params(ref_params, cfg, "cpu")
    drops = []
    if monkeypatch is not None:
        route = moe.route

        def counting_route(*a, **kw):
            r = route(*a, **kw)
            drops.append(int((~r.keep).sum()))
            return r
        monkeypatch.setattr(moe, "route", counting_route)

    shape = rc.ShapeConfig("p", S, 2, "prefill")
    ref_batch = ref_demo_inputs(ref_cfg, shape)
    batch = make_demo_inputs(cfg, tc.ShapeConfig("p", S, 2, "prefill"))
    assert sorted(batch) == sorted(ref_batch)
    for k, v in ref_batch.items():
        np.testing.assert_array_equal(batch[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    S_pos = batch["tokens"].shape[1] + frontend_len(cfg)
    cap = S_pos + steps + 1
    want, ref_caches = ref_jit(ref_lm.prefill, ref_params, ref_batch, cap,
                               static_argnums=(2,))(ref_params, ref_batch,
                                                    cap)
    got, caches = lm.prefill(params, batch, cap)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    check_caches(ref_lm, ref_caches, caches, tol)

    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, steps))
    ref_step = None
    for i in range(steps):
        step_in = {"token": jnp.asarray(toks[:, i], jnp.int32),
                   "cache_len": jnp.asarray(S_pos + i, jnp.int32)}
        ref_step = ref_step or ref_jit(ref_lm.decode_step, ref_params,
                                       ref_caches, step_in)
        want, ref_caches = ref_step(ref_params, ref_caches, step_in)
        got, caches = lm.decode_step(
            params, caches, {"token": torch.from_numpy(toks[:, i]).long(),
                             "cache_len": S_pos + i})
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol,
                                   err_msg=f"decode step {i}")
    check_caches(ref_lm, ref_caches, caches, tol)
    return drops


def check_caches(ref_lm, ref_caches, caches, tol=TOL):
    """Per decoder layer: the same cache names (k/v, conv_x/conv_b/conv_c/h,
    ck/cv), shapes and values within ``tol``."""
    ref_layers = layers_of_segments(ref_lm.program, ref_caches)
    assert len(ref_layers) == len(caches) == ref_lm.cfg.num_layers
    for i, (rl, pl) in enumerate(zip(ref_layers, caches)):
        assert sorted(rl) == sorted(pl), (i, sorted(rl), sorted(pl))
        for k in rl:
            want = np.asarray(rl[k])
            assert tuple(pl[k].shape) == want.shape, (i, k)
            np.testing.assert_allclose(pl[k].float().numpy(),
                                       want.astype(np.float32), **tol,
                                       err_msg=f"layer {i} {k}")


def check_train_parity(arch, S=32, remat=True):
    """The train loss and every gradient of one reduced fp32 config: the
    port's ``LM.train_loss`` and ``.backward`` against the reference's
    ``jax.value_and_grad(lm.train_loss)``, on the same weights and demo
    inputs of a train shape (S positions, a frontend's included). Loss
    within 1e-5 relative; each gradient within atol 1e-5, rtol 1e-4: the
    backward sums in fp32 in another order than XLA's."""
    ref_cfg, cfg = cfgs(arch)
    ref_lm, lm = RefLM(ref_cfg), LM(cfg)
    ref_params = ref_lm.init(jax.random.PRNGKey(1))
    params = from_jax_lm_params(ref_params, cfg, "cpu")
    ref_batch = ref_demo_inputs(ref_cfg, rc.ShapeConfig("t", S, 2, "train"))
    batch = make_demo_inputs(cfg, tc.ShapeConfig("t", S, 2, "train"))
    want, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_lm.train_loss(p, b, remat=remat)))(ref_params,
                                                             ref_batch)
    leaves, rebuild = flatten(params)
    live = [p.requires_grad_() for p in leaves]
    loss = lm.train_loss(params, batch, remat=remat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=0)
    ref_tree = {"layers": layers_of_segments(ref_lm.program,
                                             ref_grads["segments"]),
                "head": {k: ref_grads[k] for k in params["head"]}}
    if lm.enc_program:
        ref_tree["encoder"] = layers_of_segments(ref_lm.enc_program,
                                                 ref_grads["encoder"])
    pairs = []
    tree_map(lambda w, g: pairs.append((w, g)), ref_tree,
             rebuild([p.grad for p in live]))
    assert len(pairs) == len(live)
    for i, (w, g) in enumerate(pairs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=f"gradient leaf {i}")
