"""How far the port's bf16 ``LM``, running free, lies from the reference,
beside how far the reference's two compiles lie from each other.

Reduced configs at ``dtype="bfloat16"``, the reference's ``LM.init``
weights bridged by ``from_jax_lm_params``, each package's demo inputs;
prefill and eight decode steps' logits, each model on its own state. Three
distances, each the largest |a - b| over those logits in units of flash's
bf16 bound 2e-2 + 2e-2·|b| (1.0 is at the bound), all printed:

- the port from the reference compiled at its code's cast points
  (``torch_parity.ref_jit``, XLA's excess precision off);
- the reference compiled as it normally runs (XLA's defaults, which keep
  some bf16 intermediates in fp32) from the same;
- the port from the reference as it normally runs.

The test holds the first within the bound, or within the second where
that is larger: the port may be no farther from the reference than the
reference's own default compile is. ``test_torch_models_bf16.py`` holds
every cast point of these configs within the bound step by step, and all
but qwen3-moe end to end. Reduced qwen3-moe's residual stream reaches
|x| ~ 380, where one bf16 ulp is 2.0: one fp32 sum rounded to bf16 the
other way (a norm's mean, a GEMM, summed in another order than XLA's)
moves its free-running logits past the bound at some weight seeds and
not at others, so it runs at four (ROADMAP.md §3)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as rc  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from torch_parity import (RefLM, LM, cfgs, frontend_len,  # noqa: E402
                          from_jax_lm_params, make_demo_inputs,
                          ref_demo_inputs, ref_jit)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
CASES = ([("qwen3-moe-30b-a3b", seed) for seed in (1, 2, 3, 4)]
         + [(arch, 1) for arch in ("llama3-8b", "gemma3-1b", "mamba2-2.7b",
                                   "paligemma-3b")])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_logits(arch, seed, jit=None, S=40, steps=8):
    """Prefill and eight decode steps' logits of one reduced bf16 config at
    weight seed ``seed``, each model on its own state: the port's, or the
    reference's compiled by ``jit``."""
    ref_cfg, cfg = cfgs(arch, dtype="bfloat16")
    ref_lm = RefLM(ref_cfg)
    ref_params = ref_lm.init(jax.random.PRNGKey(seed))
    ref_batch = ref_demo_inputs(ref_cfg, rc.ShapeConfig("p", S, 2,
                                                        "prefill"))
    S_pos = ref_batch["tokens"].shape[1] + frontend_len(cfg)
    cap = S_pos + steps + 1
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, steps))
    if jit is None:
        lm, params = LM(cfg), from_jax_lm_params(ref_params, cfg, "cpu")
        out, caches = lm.prefill(params, make_demo_inputs(
            cfg, tc.ShapeConfig("p", S, 2, "prefill")), cap)
        outs = [out]
        for i in range(steps):
            out, caches = lm.decode_step(params, caches, {
                "token": torch.from_numpy(toks[:, i]).long(),
                "cache_len": S_pos + i})
            outs.append(out)
        return [o.float().numpy() for o in outs]
    out, caches = jit(ref_lm.prefill, ref_params, ref_batch, cap,
                      static_argnums=(2,))(ref_params, ref_batch, cap)
    outs, step = [out], None
    for i in range(steps):
        step_in = {"token": jnp.asarray(toks[:, i], jnp.int32),
                   "cache_len": jnp.asarray(S_pos + i, jnp.int32)}
        step = step or jit(ref_lm.decode_step, ref_params, caches, step_in)
        out, caches = step(ref_params, caches, step_in)
        outs.append(out)
    return [np.asarray(o, np.float32) for o in outs]


def worst(got, want):
    """The largest |got - want| over the logits, in units of BF16_TOL's
    bound."""
    return max(float((np.abs(g - w) / (BF16_TOL["atol"] + BF16_TOL["rtol"]
                                       * np.abs(w))).max())
               for g, w in zip(got, want, strict=True))


def default_jit(fn, *args, static_argnums=()):
    """``fn`` compiled as the reference normally runs (XLA's defaults)."""
    return jax.jit(fn, static_argnums=static_argnums)


@pytest.mark.parametrize("arch,seed", CASES)
def test_bf16_drift_within_reference_spread(arch, seed):
    exact = free_logits(arch, seed, ref_jit)
    default = free_logits(arch, seed, default_jit)
    port = free_logits(arch, seed)
    to_exact, spread, to_default = (worst(port, exact),
                                    worst(default, exact),
                                    worst(port, default))
    print(f"{arch} seed {seed}, in units of the bound: the port from the "
          f"exact-cast reference {to_exact:.3f}; the default-compiled "
          f"reference from it {spread:.3f}; the port from the "
          f"default-compiled reference {to_default:.3f}")
    assert to_exact <= max(1.0, spread), (to_exact, spread)
