"""The reference's runs on a (data, model) mesh, for the port's mesh tests
(``tests/test_torch_moe_ep.py``, ``tests/test_torch_mesh_train.py``,
``tests/test_torch_mesh_families.py``, ``tests/test_torch_mesh_serve.py``,
``tests/test_torch_mesh_serve_families.py``,
``tests/test_torch_mesh_serve_encdec.py``), and on a (pod, data, model)
mesh (``tests/test_torch_mesh_pod.py``).

Run in a process of its own, with four XLA host devices forced before jax
loads (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), eight
for ``pod``:

    python tests/torch_mesh_ref.py moe OUT.pkl
    python tests/torch_mesh_ref.py train OUT.pkl {float32,int8}
    python tests/torch_mesh_ref.py families OUT.pkl
    python tests/torch_mesh_ref.py serve OUT.pkl
    python tests/torch_mesh_ref.py serve_families OUT.pkl
    python tests/torch_mesh_ref.py serve_encdec OUT.pkl
    python tests/torch_mesh_ref.py pod OUT.pkl

It pickles numpy trees. The mesh is a ``jax.sharding.Mesh`` over the
devices, whose axes are Auto: the reference's sharding constraints run
there, while ``jax.make_mesh``'s Explicit axes make its own launcher
fail (ROADMAP.md §3). Where the reference's ``shard_map`` refuses its own
``out_specs`` (no ``psum`` in the body, so jax cannot infer the output's
replication over "model": a mesh with one model shard, and the ``gcd``
fallback), the body runs again with that check off, which changes no
value; the case records that it raised.
"""
import dataclasses
import math
import pickle
import sys

import numpy as np

# moe_ffn cases: (name, mesh shape, experts, skewed routing)
MOE_CASES = (("2x2", (2, 2), 4, False), ("1x4", (1, 4), 4, False),
             ("2x1", (2, 1), 4, False), ("gcd_E6_M4", (1, 4), 6, False),
             ("drops", (2, 2), 4, True))
MOE_B, MOE_S = 4, 8
# train steps: reduced configs in fp32, batch 4 x 32 in 2 microbatches
ARCHS = ("llama3-8b", "gemma3-1b", "qwen3-moe-30b-a3b")
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 32, 2
# the SSM, hybrid, frontend and encoder-decoder families, reduced, in fp32,
# on (2, 2); jamba at one whole period; and mamba2 on (1, 2) with
# expand 3, head_dim 64 (d_in 192 splits over "model", its 3 heads do not)
FAMILY_CASES = (("mamba2-2.7b", (2, 2), {}),
                ("jamba-1.5-large-398b", (2, 2), {"num_layers": 8}),
                ("paligemma-3b", (2, 2), {}),
                ("seamless-m4t-medium", (2, 2), {}),
                ("mamba2-2.7b", (1, 2), {"ssm": dict(expand=3, head_dim=64)}))


# prefill and decode: reduced configs in fp32 (gemma3 at six layers: five
# local with 32-token rings and one global), batch 4, a 28-token prompt,
# capacity 64 (62 on one (2, 2) case, which the decode's kv_seq split over
# four positions does not divide), then 6 decode steps that write slots
# 28-33: across the kv_seq piece boundary at 32 and round gemma3's rings
SERVE_ARCHS = (("llama3-8b", {}), ("gemma3-1b", {"num_layers": 6}))
SERVE_CASES = (((2, 2), 64), ((1, 4), 64), ((4, 1), 64), ((2, 2), 62))
SERVE_B, SERVE_PROMPT, SERVE_STEPS = 4, 28, 6


# prefill and decode of the MoE, SSM and hybrid families: reduced configs
# in fp32 with SERVE_B, SERVE_PROMPT and SERVE_STEPS; qwen3-moe on (2, 2)
# and (1, 4), mamba2 on (2, 2) and on (1, 2) with expand 3, head_dim 64
# (d_in 192 splits over "model", its 3 heads do not), jamba at one whole
# period on (2, 2) at capacity 62 (its attention layer's decode cache
# keeps its slots whole: four pieces do not divide them)
SERVE_FAMILY_CASES = (("qwen3-moe-30b-a3b", (2, 2), 64, {}),
                      ("qwen3-moe-30b-a3b", (1, 4), 64, {}),
                      ("mamba2-2.7b", (2, 2), 64, {}),
                      ("mamba2-2.7b", (1, 2), 64,
                       {"ssm": dict(expand=3, head_dim=64)}),
                      ("jamba-1.5-large-398b", (2, 2), 62,
                       {"num_layers": 8}))


# prefill and decode of the frontend and encoder-decoder families: reduced
# configs in fp32 with SERVE_B and SERVE_STEPS at capacity 64 on (2, 2),
# (1, 4) and (4, 1): paligemma's 8 image embeddings, then 20 tokens;
# seamless's 28 tokens over 8 source frames, and over 6 on (2, 2), which
# the decode's split of the cross caches' frames over four positions does
# not divide. Every decode writes slots 28-33, across the piece boundary
# at 32
SERVE_ENCDEC_CASES = tuple((arch, shape, None)
                           for arch in ("paligemma-3b", "seamless-m4t-medium")
                           for shape in ((2, 2), (1, 4), (4, 1))) + (
    ("seamless-m4t-medium", (2, 2), 6),)
SERVE_ENCDEC_CAP = 64


# the multi-pod mesh (2, 2, 2) over eight XLA host devices: one fp32 train
# step (TRAIN_B x TRAIN_S in TRAIN_MB microbatches, whose 2 rows the 4
# (pod, data) positions do not divide: the activations stay whole while
# the MoE's shard_map splits them over "data") of each POD_TRAIN_ARCHS
# entry; prefill and SERVE_STEPS decode steps at capacity 64 of each
# POD_SERVE_CASES entry (arch, batch), reduced fp32, batch 2 whole on
# every position likewise
POD_SHAPE = (2, 2, 2)
POD_DEVICES = 8
POD_TRAIN_ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b")
POD_SERVE_CASES = (("llama3-8b", 4), ("qwen3-moe-30b-a3b", 4),
                   ("mamba2-2.7b", 4), ("seamless-m4t-medium", 4),
                   ("llama3-8b", 2))
POD_CAP = 64


def pod_serve_name(arch, batch):
    return f"{arch}@b{batch}"


def serve_encdec_name(arch, shape, frames):
    tag = f"+{frames}frames" if frames else ""
    return f"{arch}{tag}@{shape[0]}x{shape[1]}"


def serve_encdec_cfg(rc, arch, frames):
    """The reduced fp32 config of a ``SERVE_ENCDEC_CASES`` entry, with
    ``frames`` frontend embeddings where given."""
    cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                              dtype="float32")
    if frames:
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, num_embeds=frames))
    return cfg


def frontend_key(cfg):
    """The batch key of a config's frontend embeddings: ``embeds`` ahead
    of a decoder's tokens, an encoder's ``src_embeds``, or None."""
    if cfg.frontend.kind == "none":
        return None
    return "src_embeds" if cfg.num_encoder_layers else "embeds"


def serve_prompt(cfg):
    """The prompt's tokens: ``SERVE_PROMPT`` less a decoder's frontend
    embeddings, so that every config's decode steps write slots
    ``SERVE_PROMPT`` onwards (their ``cache_len``)."""
    return SERVE_PROMPT - (cfg.frontend.num_embeds
                           if frontend_key(cfg) == "embeds" else 0)


def serve_embeds(cfg):
    """A frontend's embeddings (SERVE_B, F, e) in fp32 from numpy seed 0,
    or None."""
    if frontend_key(cfg) is None:
        return None
    return np.random.default_rng(0).standard_normal(
        (SERVE_B, cfg.frontend.num_embeds, cfg.frontend.embed_dim)
    ).astype(np.float32)


def serve_family_name(arch, shape, cap, over):
    tag = "+ssm" if "ssm" in over else ""
    return f"{arch}{tag}@{serve_case_name(shape, cap)}"


def serve_case_name(shape, cap):
    return f"{shape[0]}x{shape[1]}@{cap}"


def serve_cfg(rc, arch, over):
    return dataclasses.replace(rc.get_config(arch).reduced(),
                               dtype="float32", **over)


def serve_tokens(cfg):
    """The prompt and the decode steps' tokens (numpy seed 0)."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + SERVE_STEPS)
    ).astype(np.int32)


def family_case_name(arch, shape):
    return f"{arch}@{shape[0]}x{shape[1]}"


def family_cfg(rc, arch, over):
    """The reduced fp32 config of a ``FAMILY_CASES`` entry, from either
    package's ``configs`` module ``rc``."""
    cfg = rc.get_config(arch).reduced()
    over = dict(over)
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return dataclasses.replace(cfg, dtype="float32", **over)


def family_batch(cfg):
    """``SyntheticPacked`` seed 0 (4 x 32 tokens) and, for a frontend, its
    ``embeds`` (decoder-only) or ``src_embeds`` (encoder-decoder) of
    ``frontend.num_embeds`` rows from numpy seed 0."""
    from repro.data.pipeline import SyntheticPacked
    batch = dict(next(iter(SyntheticPacked(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                           seed=0))))
    if cfg.frontend.kind != "none":
        key = "src_embeds" if cfg.num_encoder_layers else "embeds"
        batch[key] = np.random.default_rng(0).standard_normal(
            (TRAIN_B, cfg.frontend.num_embeds, cfg.frontend.embed_dim)
        ).astype(np.float32)
    return batch


def moe_inputs(cfg, E, skewed, seed):
    """x (B, S, d) and the MoE weights in fp32 from a numpy seed. Skewed:
    the first half of the batch (data shard 0 of two) leans to expert 0,
    the second half away from it."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((MOE_B, MOE_S, d))
    if skewed:
        u = rng.standard_normal(d)
        u /= np.linalg.norm(u)
        p["router"][:, 0] = 4.0 * u
        sign = np.where(np.arange(MOE_B) < MOE_B // 2, 1.0, -1.0)
        x = 0.3 * x + 3.0 * sign[:, None, None] * u
    return (x.astype(np.float32),
            {k: v.astype(np.float32) for k, v in p.items()})


def auto_mesh(shape):
    """An Auto-axes mesh over ("data", "model"), or ("pod", "data",
    "model") for a shape of three."""
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    return Mesh(devs, ("pod", "data", "model")[-len(shape):])


def _unchecked_shard_map():
    """``jax.shard_map`` with ``check_vma=False``: the reference's body
    and specs, without the replication check it fails."""
    import functools
    import jax
    orig = jax.shard_map
    jax.shard_map = functools.partial(orig, check_vma=False)
    return lambda: setattr(jax, "shard_map", orig)


def moe_runs():
    import jax
    import jax.numpy as jnp
    import repro.configs as rc
    from repro.distributed.sharding import TRAIN_RULES, sharding_ctx
    from repro.models.moe import moe_ffn
    base = rc.get_config("qwen3-moe-30b-a3b").reduced()
    out = {}
    for i, (name, shape, E, skewed) in enumerate(MOE_CASES):
        mcfg = dataclasses.replace(base.moe, num_experts=E)
        x, p = moe_inputs(base, E, skewed, seed=i)
        xj, pj = jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}
        # a new function each trace: jit's cache does not see the context
        raised = None
        with sharding_ctx(auto_mesh(shape), TRAIN_RULES):
            try:
                mesh_out = jax.jit(lambda a, b: moe_ffn(a, b, mcfg))(xj, pj)
            except ValueError as e:
                raised = str(e).splitlines()[0]
                restore = _unchecked_shard_map()
                mesh_out = jax.jit(lambda a, b: moe_ffn(a, b, mcfg))(xj, pj)
                restore()
        whole = jax.jit(lambda a, b: moe_ffn(a, b, mcfg))(xj, pj)
        out[name] = dict(x=x, params=p, mesh=np.asarray(mesh_out),
                         whole=np.asarray(whole), raised=raised)
    return out


def train_runs(moments):
    import jax
    import repro.configs as rc
    from repro.data.pipeline import SyntheticPacked
    from repro.distributed.sharding import TRAIN_RULES, sharding_ctx
    from repro.models.lm import LM
    from repro.optimizer import adamw
    from repro.training import step as steplib
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    mesh = auto_mesh((2, 2))
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(rc.get_config(arch).reduced(),
                                  dtype="float32")
        lm = LM(cfg)
        batch = next(iter(SyntheticPacked(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                          seed=0)))
        out[arch] = {"batch": batch}
        for md in moments:
            opt = adamw.AdamWConfig(moments_dtype=md, warmup_steps=1)
            fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB)
            with sharding_ctx(mesh, TRAIN_RULES):
                state = steplib.init_train_state(lm, jax.random.PRNGKey(0),
                                                 opt)
                new, met = jax.jit(fn)(state, batch)
            out[arch][md] = dict(loss=float(met["loss"]),
                                 grad_norm=float(met["grad_norm"]),
                                 state=to_np(new))
            out[arch]["params0"] = to_np(state.params)
        if cfg.moe is not None and "float32" in moments:
            # the same step with no mesh: capacity counts the whole batch
            opt = adamw.AdamWConfig(warmup_steps=1)
            fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB)
            _, met = jax.jit(fn)(steplib.init_train_state(
                lm, jax.random.PRNGKey(0), opt), batch)
            out[arch]["loss_no_mesh"] = float(met["loss"])
    return out


def family_runs():
    """One fp32 step of each ``FAMILY_CASES`` entry under
    ``sharding_ctx(mesh, TRAIN_RULES)``, from ``PRNGKey(0)`` weights."""
    import jax
    import repro.configs as rc
    from repro.distributed.sharding import TRAIN_RULES, sharding_ctx
    from repro.models.lm import LM
    from repro.optimizer import adamw
    from repro.training import step as steplib
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch, shape, over in FAMILY_CASES:
        cfg = family_cfg(rc, arch, over)
        lm = LM(cfg)
        batch = family_batch(cfg)
        opt = adamw.AdamWConfig(warmup_steps=1)
        fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB)
        with sharding_ctx(auto_mesh(shape), TRAIN_RULES):
            state = steplib.init_train_state(lm, jax.random.PRNGKey(0), opt)
            new, met = jax.jit(fn)(state, batch)
        out[family_case_name(arch, shape)] = dict(
            batch=batch, params0=to_np(state.params),
            loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
            state=to_np(new))
    return out


def _serve_case(lm, params, toks, shape, cap, embeds=None):
    """One prefill under ``PREFILL_RULES`` and ``SERVE_STEPS`` decode
    steps under ``DECODE_RULES`` on ``auto_mesh(shape)``: the prefill's
    logits and caches, each step's logits, the last caches; and the first
    line of the error the ``shard_map`` replication check raised, where it
    did (the run then repeats without the check, which changes no
    value). ``embeds``: a frontend's embeddings (``serve_embeds``), laid
    out by their logical axes in ``repro.models.api.batch_specs``; the
    prompt is ``serve_prompt`` tokens, and the caches hold an encoder's
    frames."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import ShapeConfig
    from repro.distributed.sharding import (DECODE_RULES, PREFILL_RULES,
                                            pspec_for, sharding_ctx)
    from repro.launch.dryrun import _axes_leaf
    from repro.models.api import batch_specs
    from repro.models.common import specs_logical_axes
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    mesh = auto_mesh(shape)
    key, plen = frontend_key(lm.cfg), serve_prompt(lm.cfg)
    B = toks.shape[0]

    def shardings(axes, rules):
        return jax.tree.map(lambda a: NamedSharding(
            mesh, pspec_for(a[0] or (), mesh, rules, a[1])),
            axes, is_leaf=_axes_leaf)
    batch = {"tokens": toks[:, :plen]}
    batch_axes = {"tokens": (("batch", None), batch["tokens"].shape)}
    src_len = 0
    if key is not None:
        spec = batch_specs(lm.cfg, ShapeConfig("p", SERVE_PROMPT, B,
                                               "prefill"))[key]
        batch[key] = embeds
        batch_axes[key] = (spec.logical_axes, embeds.shape)
        src_len = embeds.shape[1] if key == "src_embeds" else 0
    cache_axes = specs_logical_axes(lm.cache_specs(B, cap, src_len))

    def run():
        with sharding_ctx(mesh, PREFILL_RULES):
            prefill = jax.jit(
                lambda p, b: lm.prefill(p, b, cap),
                in_shardings=(shardings(lm.param_axes(), PREFILL_RULES),
                              shardings(batch_axes, PREFILL_RULES)))
            logits, caches = prefill(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        case = {"prefill": np.asarray(logits),
                "prefill_caches": to_np(caches), "decode": []}
        with sharding_ctx(mesh, DECODE_RULES):
            step = jax.jit(lm.decode_step, in_shardings=(
                shardings(lm.param_axes(), DECODE_RULES),
                shardings(cache_axes, DECODE_RULES),
                shardings({"token": (("batch",), (B,)),
                           "cache_len": ((), ())}, DECODE_RULES)))
            caches = jax.device_put(caches,
                                    shardings(cache_axes, DECODE_RULES))
            for i in range(SERVE_STEPS):
                logits, caches = step(params, caches, {
                    "token": jnp.asarray(toks[:, plen + i]),
                    "cache_len": jnp.asarray(SERVE_PROMPT + i,
                                             jnp.int32)})
                case["decode"].append(np.asarray(logits))
        case["decode_caches"] = to_np(caches)
        return case

    try:
        case = run()
        case["raised"] = None
    except ValueError as e:
        restore = _unchecked_shard_map()
        try:
            case = run()
        finally:
            restore()
        case["raised"] = str(e).splitlines()[0]
    return case


def serve_runs():
    """The reference's jitted ``lm.prefill`` under ``sharding_ctx(mesh,
    PREFILL_RULES)`` and ``SERVE_STEPS`` ``lm.decode_step``s under
    ``DECODE_RULES``, their inputs laid out by ``pspec_for`` as
    ``repro.launch.inspect_hlo`` lays them, the prefill's caches moved to
    the decode's layout by ``device_put``; ``PRNGKey(0)`` weights."""
    import jax
    import repro.configs as rc
    from repro.models.lm import LM
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch, over in SERVE_ARCHS:
        cfg = serve_cfg(rc, arch, over)
        lm = LM(cfg)
        params = lm.init(jax.random.PRNGKey(0))
        toks = serve_tokens(cfg)
        res = out[arch] = {"params": to_np(params), "tokens": toks}
        for shape, cap in SERVE_CASES:
            case = _serve_case(lm, params, toks, shape, cap)
            assert case.pop("raised") is None
            res[serve_case_name(shape, cap)] = case
    return out


def serve_family_runs():
    """``serve_runs`` for ``SERVE_FAMILY_CASES`` (the MoE ``shard_map``
    runs inside the jitted steps), each from ``PRNGKey(0)`` weights."""
    import jax
    import repro.configs as rc
    from repro.models.lm import LM
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch, shape, cap, over in SERVE_FAMILY_CASES:
        cfg = family_cfg(rc, arch, over)
        lm = LM(cfg)
        params = lm.init(jax.random.PRNGKey(0))
        toks = serve_tokens(cfg)
        case = _serve_case(lm, params, toks, shape, cap)
        case.update(params=to_np(params), tokens=toks)
        out[serve_family_name(arch, shape, cap, over)] = case
    return out


def serve_encdec_runs():
    """``serve_runs`` for ``SERVE_ENCDEC_CASES``: the frontend's
    embeddings or the encoder's source frames in the prefill's batch,
    each case from ``PRNGKey(0)`` weights."""
    import jax
    import repro.configs as rc
    from repro.models.lm import LM
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {}
    for arch, shape, frames in SERVE_ENCDEC_CASES:
        cfg = serve_encdec_cfg(rc, arch, frames)
        lm = LM(cfg)
        params = lm.init(jax.random.PRNGKey(0))
        toks, embeds = serve_tokens(cfg), serve_embeds(cfg)
        case = _serve_case(lm, params, toks, shape, SERVE_ENCDEC_CAP, embeds)
        case.update(params=to_np(params), tokens=toks, embeds=embeds)
        out[serve_encdec_name(arch, shape, frames)] = case
    return out


def pod_runs():
    """``train_runs`` (fp32 moments) for ``POD_TRAIN_ARCHS`` and
    ``serve_runs`` for ``POD_SERVE_CASES``, all on ``POD_SHAPE``, each
    from ``PRNGKey(0)`` weights."""
    import jax
    import repro.configs as rc
    from repro.data.pipeline import SyntheticPacked
    from repro.distributed.sharding import TRAIN_RULES, sharding_ctx
    from repro.models.lm import LM
    from repro.optimizer import adamw
    from repro.training import step as steplib
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"train": {}, "serve": {}}
    for arch in POD_TRAIN_ARCHS:
        cfg = serve_cfg(rc, arch, {})
        lm = LM(cfg)
        batch = next(iter(SyntheticPacked(cfg.vocab_size, TRAIN_S, TRAIN_B,
                                          seed=0)))
        opt = adamw.AdamWConfig(warmup_steps=1)
        fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB)
        with sharding_ctx(auto_mesh(POD_SHAPE), TRAIN_RULES):
            state = steplib.init_train_state(lm, jax.random.PRNGKey(0), opt)
            new, met = jax.jit(fn)(state, batch)
        out["train"][arch] = dict(
            batch=batch, params0=to_np(state.params),
            loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
            state=to_np(new))
    for arch, B in POD_SERVE_CASES:
        cfg = serve_cfg(rc, arch, {})
        lm = LM(cfg)
        params = lm.init(jax.random.PRNGKey(0))
        toks = serve_tokens(cfg)[:B]
        embeds = serve_embeds(cfg)
        embeds = embeds[:B] if embeds is not None else None
        case = _serve_case(lm, params, toks, POD_SHAPE, POD_CAP, embeds)
        case.update(params=to_np(params), tokens=toks, embeds=embeds)
        out["serve"][pod_serve_name(arch, B)] = case
    return out


if __name__ == "__main__":
    what, path = sys.argv[1], sys.argv[2]
    res = (moe_runs() if what == "moe" else family_runs()
           if what == "families" else serve_runs() if what == "serve"
           else serve_family_runs() if what == "serve_families"
           else serve_encdec_runs() if what == "serve_encdec"
           else pod_runs() if what == "pod"
           else train_runs(sys.argv[3:]))
    with open(path, "wb") as fh:
        pickle.dump(res, fh)
