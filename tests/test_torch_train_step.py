"""The port's training slice as a whole against the reference on the CPU:
yi-34b reduced in fp32, the reference's ``LM.init`` weights bridged into
the port, the same ``SyntheticPacked`` batches (seed 0), two microbatches,
three steps of ``make_train_step`` in each moment dtype (fp32, bf16,
int8). Losses within 1e-5 relative, parameters within atol 1e-5 (fp32
updates of order lr from gradients equal within 1e-5), moments within
atol 1e-6, int8 scales within 1e-5 relative; the step counter equal.

Stored moments (int8 codes, bf16 values) are held twice. Step by step,
each from the reference's state: the port's are exactly the
round-half-to-even of its own fp32 values, and each apart from the
reference's rounds a value within the gradients' agreement of the port's
(``stored_equal``), at most ``MAX_APART`` in three steps. Free running, the
port on its own state: losses and parameters, parameters whose moments
came out apart at most one learning rate off. Plus ``make_step_bundle``'s
train step is the same function, and ``train_state_structs`` matches
``init_train_state``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as rc  # noqa: E402
from repro.data.pipeline import SyntheticPacked as RefData  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from repro.optimizer import adamw as ref_adamw  # noqa: E402
from repro.training import step as ref_step  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.data.pipeline import SyntheticPacked  # noqa: E402
from repro_torch.models.api import make_step_bundle  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       layers_of_segments)
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.training import step as steplib  # noqa: E402
from repro_torch.tree import flatten, tree_leaves, tree_map  # noqa: E402

B, S, STEPS = 4, 32, 3
# stored moment values apart from the reference's in three steps of
# ~1.08 M stored values (180,800 parameters, m and v): 20 int8 codes and
# 580 bf16 values measured on the CPU; the bound is twice that
MAX_APART = {"float32": 0, "bfloat16": 1160, "int8": 40}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs():
    return tuple(dataclasses.replace(m.get_config("yi-34b").reduced(),
                                     dtype="float32") for m in (rc, tc))


def port_tree(ref_lm, tree):
    """A reference tree laid out like ``LM.init``'s (segments + head
    leaves; int8 moments as ``Quantized`` nodes) as the port's per-layer
    tree."""
    is_q = lambda x: isinstance(x, ref_adamw.Quantized)  # noqa: E731
    if any(is_q(x) for x in jax.tree.leaves(tree, is_leaf=is_q)):
        q, s = (port_tree(ref_lm, jax.tree.map(lambda x: x[i], tree,
                                               is_leaf=is_q))
                for i in (0, 1))
        return tree_map(adamw.Quantized, q, s)
    out = {"layers": layers_of_segments(ref_lm.program, tree["segments"]),
           "head": {k: tree[k] for k in ("embed", "final_norm", "lm_head",
                                         "frontend_proj", "enc_norm")
                    if k in tree}}
    if ref_lm.enc_program:
        out["encoder"] = layers_of_segments(ref_lm.enc_program,
                                            tree["encoder"])
    return out


def bridge_state(ref_lm, ref_state, cfg):
    """The reference's TrainState as the port's: params at cfg.dtype,
    moments in their stored dtypes (int8 codes and fp32 scales, bf16 or
    fp32), the step counter as int32."""
    to_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    params = from_jax_lm_params(ref_state.params, cfg, "cpu")

    def moments(tree):
        t = port_tree(ref_lm, tree)
        if moments_are_bf16(tree):
            return tree_map(lambda a: to_t(np.asarray(a, np.float32)).to(
                torch.bfloat16), t)
        return tree_map(lambda a: adamw.Quantized(to_t(a.q), to_t(a.scale))
                        if isinstance(a, adamw.Quantized) else to_t(a), t,
                        is_leaf=lambda a: isinstance(a, adamw.Quantized))
    opt = adamw.AdamWState(torch.tensor(int(ref_state.opt.step),
                                        dtype=torch.int32),
                           moments(ref_state.opt.m), moments(ref_state.opt.v))
    return steplib.TrainState(params, opt)


def moments_are_bf16(tree):
    return str(jax.tree.leaves(tree)[0].dtype) == "bfloat16"


def record_stores(monkeypatch):
    """Each value the port's optimizer stores, keyed by the stored
    tensor's id: the fp32 value before its cast or quantization (for int8
    v, its square root, taken by the same ``torch.sqrt``)."""
    seen = {}
    store = adamw._store

    def recording(x, mode, sqrt_map=False):
        out = store(x, mode, sqrt_map)
        if mode != "float32":
            pre = torch.sqrt(torch.clamp(x, min=0.0)) if (
                sqrt_map and mode == "int8") else x
            seen[id(out.q if mode == "int8" else out)] = pre.numpy()
        return out
    monkeypatch.setattr(adamw, "_store", recording)
    return seen


def bf16_bits(x):
    """fp32 -> bf16 bit patterns (int16), rounding half to even."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(
        np.uint16).view(np.int16)


def bf16_value(bits):
    """bf16 bit patterns (any int dtype) -> their values in fp64."""
    b = np.asarray(bits).astype(np.int16).view(np.uint16).astype(np.uint32)
    return (b << 16).view(np.float32).astype(np.float64)


def bf16_interval(bits):
    """(lo, hi): the fp32 values that round to the bf16 bit patterns
    ``bits``, from the midpoints to their neighbours."""
    b = np.asarray(bits).astype(np.int16).view(np.uint16).astype(np.int64)
    sign = np.where(b & 0x8000, -1.0, 1.0)
    mag = b & 0x7FFF
    at = bf16_value(mag)
    lo = np.where(mag > 0, (at + bf16_value(np.maximum(mag - 1, 0))) / 2,
                  -bf16_value(np.ones_like(mag)) / 2)
    hi = (at + bf16_value(mag + 1)) / 2
    return np.minimum(sign * lo, sign * hi), np.maximum(sign * lo, sign * hi)


def int8_codes(x):
    """fp32 (..., L) -> (x, codes, block scales): the blockwise int8 rule
    (scale = block max * fp32(1/127), codes rounded half to even and
    clipped to +-127), in numpy."""
    x = np.asarray(x, np.float32).reshape(np.shape(x) or (1,))
    L = x.shape[-1]
    b = adamw._block_of(L)
    g = x.reshape(*x.shape[:-1], L // b, b)
    scale = np.maximum(np.abs(g).max(-1) * np.float32(1.0 / 127.0),
                       np.float32(1e-12))
    q = np.clip(np.round(g / scale[..., None]), -127, 127)
    return x, q.reshape(x.shape).astype(np.int8), scale


def stored_equal(want, got, pre, what):
    """A stored moment (int8 codes, or bf16 values) of the port against the
    reference's. The port's is exactly the round-half-to-even of its own
    fp32 value ``pre``, codes and scales recomputed here.
    A code or value apart from the reference's is excused only where the
    reference's rounds an fp32 value within ``delta`` = 1e-5 * the leaf's
    max |x| of the port's: the gradients agree to about 1e-6 of their
    leaf's largest, not bit for bit, so a value at a rounding tie may round
    either way (an int8 code one apart), and a bf16 value much smaller than
    its leaf's largest may be a few ulps apart. Returns those as (what,
    index, port's fp32 value, reference, port)."""
    x = pre
    if isinstance(got, adamw.Quantized):
        x, codes, scale = int8_codes(x)
        np.testing.assert_array_equal(got.q.numpy(), codes, err_msg=what)
        np.testing.assert_array_equal(got.scale.numpy(), scale, err_msg=what)
        got_np, want_np = got.q.numpy(), np.asarray(want.q)
        s = np.repeat(scale, x.shape[-1] // scale.shape[-1], axis=-1)
        lo, hi = ((want_np - 0.5) * s.astype(np.float64),
                  (want_np + 0.5) * s.astype(np.float64))
    else:
        got_np, want_np = got.view(torch.int16).numpy(), np.asarray(
            want).view(np.int16)
        np.testing.assert_array_equal(got_np, bf16_bits(x), err_msg=what)
        lo, hi = bf16_interval(want_np)
    delta = 1e-5 * float(np.abs(x).max())
    off = np.maximum(np.maximum(lo - x, x - hi), 0)
    ties = []
    for idx in map(tuple, np.argwhere(got_np != want_np)):
        entry = (what, idx, float(x[idx]), int(want_np[idx]),
                 int(got_np[idx]))
        assert off[idx] <= delta, (entry, off[idx], delta)
        ties.append(entry)
    return ties


def compare(ref_tree, got, what, stored, **tol):
    """Leaf by leaf: stored moments as ``stored_equal`` says (int8 scales
    within 1e-5 relative, as the block maxima agree), the rest, and bf16
    values off a tie, within ``tol``. Returns the rounding ties found."""
    pairs = []
    tree_map(lambda w, g: pairs.append((w, g)), ref_tree, got,
             is_leaf=lambda x: isinstance(x, adamw.Quantized))
    assert pairs
    ties = []
    for i, (w, g) in enumerate(pairs):
        name = f"{what}, leaf {i}"
        if isinstance(g, adamw.Quantized):
            ties += stored_equal(w, g, stored[id(g.q)], name)
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale),
                                       rtol=1e-5, atol=0, err_msg=name)
            continue
        raw, w = np.asarray(w), np.asarray(w, np.float32)
        got = g.float().numpy()
        if g.dtype == torch.bfloat16 and id(g) in stored:
            found = stored_equal(raw, g, stored[id(g)], name)
            ties += found
            for _, idx, *_ in found:
                got[idx] = w[idx]
        np.testing.assert_allclose(got, w, **tol, err_msg=name)
    return ties


def start(moments):
    """(reference LM, its compiled train step, its state, the port's
    train step, the port's state): yi-34b reduced, ``moments`` dtype, the
    same weights, two microbatches."""
    ref_cfg, cfg = cfgs()
    ref_lm = RefLM(ref_cfg)
    opt_ref = ref_adamw.AdamWConfig(moments_dtype=moments, warmup_steps=1)
    opt = adamw.AdamWConfig(moments_dtype=moments, warmup_steps=1)
    ref_params = ref_lm.init(jax.random.PRNGKey(0))
    ref_state = ref_step.TrainState(ref_params,
                                    ref_adamw.init_state(ref_params, opt_ref))
    ref_fn = jax.jit(ref_step.make_train_step(ref_lm, opt_ref,
                                              microbatches=2))
    fn = steplib.make_train_step(LM(cfg), opt, microbatches=2)
    return ref_lm, ref_fn, ref_state, fn, bridge_state(ref_lm, ref_state,
                                                       cfg)


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_three_steps_match_reference(moments, monkeypatch):
    """Three steps from the same state: before each, the port takes the
    reference's state (bridged), so that every stored moment is held to
    the reference's rounding of the same step. A value stored apart
    (``stored_equal``; printed) does not carry into the next step; the
    port's own state runs three steps in
    ``test_three_free_steps_match_reference``."""
    stored = record_stores(monkeypatch)
    ref_lm, ref_fn, ref_state, fn, _ = start(moments)
    _, cfg = cfgs()
    ref_data, data = RefData(cfg.vocab_size, S, B), SyntheticPacked(
        cfg.vocab_size, S, B)
    ties, n_stored = [], 0
    for i in range(STEPS):
        state = bridge_state(ref_lm, ref_state, cfg)
        rb = next(ref_data)
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        stored.clear()
        ref_state, ref_m = ref_fn(ref_state, rb)
        state, m = fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5, atol=0, err_msg=f"step {i}")
        assert int(state.opt.step) == int(ref_state.opt.step) == i + 1
        compare(port_tree(ref_lm, ref_state.params), state.params,
                f"params after step {i}", stored, atol=1e-5, rtol=0)
        for name in ("m", "v"):
            ties += compare(port_tree(ref_lm, getattr(ref_state.opt, name)),
                            getattr(state.opt, name),
                            f"{name} after step {i}", stored, atol=1e-6,
                            rtol=0)
        n_stored += sum(x.size for x in stored.values())
    print(f"{moments} moments, stored apart (what, index, port's fp32 "
          f"value, reference, port), {len(ties)} of {n_stored}: {ties}")
    assert len(ties) <= MAX_APART[moments], (len(ties), n_stored)


def stored_bits(tree):
    """The stored moments' leaves as numpy integers: int8 codes, bf16 bit
    patterns (None for fp32 moments, which are compared by value)."""
    out = []
    for x in tree_leaves(tree, is_leaf=lambda a: isinstance(
            a, adamw.Quantized)):
        if isinstance(x, adamw.Quantized):
            out.append(np.asarray(x.q).astype(np.int64))
        elif str(x.dtype).endswith("bfloat16"):
            out.append((x.view(torch.int16).numpy() if isinstance(
                x, torch.Tensor) else np.asarray(x).view(np.int16)).astype(
                np.int64))
        else:
            out.append(None)
    return out


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_three_free_steps_match_reference(moments):
    """The port's own state carried through three steps stays with the
    reference's: losses within 1e-5 relative; fp32 moments within atol
    1e-6; params within atol 1e-5, except at the elements whose stored m or
    v (an int8 code, a bf16 value) came out apart from the reference's at
    some step, at most ``MAX_APART`` of them, which may differ by up to
    1e-5 + lr: a moment apart moves its element's later updates by less
    than one update of the learning rate's size."""
    ref_lm, ref_fn, ref_state, fn, state = start(moments)
    lr = adamw.AdamWConfig().lr
    _, cfg = cfgs()
    apart = None
    for i, batch in zip(range(STEPS), SyntheticPacked(cfg.vocab_size, S, B)):
        ref_state, ref_m = ref_fn(ref_state, batch)
        state, m = fn(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5, atol=0, err_msg=f"step {i}")
        if moments == "float32":
            for name in ("m", "v"):
                compare(port_tree(ref_lm, getattr(ref_state.opt, name)),
                        getattr(state.opt, name), f"{name} after step {i}",
                        {}, atol=1e-6, rtol=0)
            apart = [np.zeros(p.shape, bool)
                     for p in tree_leaves(state.params)]
        else:
            now = [(w != g) | (w2 != g2) for w, g, w2, g2 in zip(
                stored_bits(port_tree(ref_lm, ref_state.opt.m)),
                stored_bits(state.opt.m),
                stored_bits(port_tree(ref_lm, ref_state.opt.v)),
                stored_bits(state.opt.v))]
            apart = now if apart is None else [a | b for a, b in
                                               zip(apart, now)]
        n_apart = int(sum(a.sum() for a in apart))
        assert n_apart <= MAX_APART[moments], (i, n_apart)
        pairs = []
        tree_map(lambda w, g: pairs.append((np.asarray(w), g.numpy())),
                 port_tree(ref_lm, ref_state.params), state.params)
        for j, ((w, g), a) in enumerate(zip(pairs, apart, strict=True)):
            what = f"params after step {i}, leaf {j}"
            np.testing.assert_allclose(np.where(a, w, g), w, atol=1e-5,
                                       rtol=0, err_msg=what)
            np.testing.assert_allclose(g[a], w[a], atol=1e-5 + lr, rtol=0,
                                       err_msg=what)
        print(f"{moments} moments, step {i}: {n_apart} elements stored "
              f"apart, params off by at most "
              f"{max(float(np.abs(w - g).max()) for w, g in pairs):.3e}")


def test_step_bundle_runs_the_train_step():
    _, cfg = cfgs()
    shape = tc.ShapeConfig("t", S, B, "train")
    bundle = make_step_bundle(cfg, shape, microbatches=2,
                              opt_cfg=adamw.AdamWConfig(moments_dtype="int8"))
    assert bundle.kind == "train"
    assert bundle.static_meta == {"microbatches": 2, "remat_group": 1,
                                  "moments_dtype": "int8",
                                  "accum_dtype": "float32"}
    lm = LM(cfg)
    opt = adamw.AdamWConfig(moments_dtype="int8")
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(SyntheticPacked(cfg.vocab_size, S, B)).items()}
    new, m = bundle.fn(state, batch)
    want, mw = steplib.make_train_step(lm, opt, microbatches=2)(state, batch)
    assert float(m["loss"]) == float(mw["loss"])
    for a, b in zip(tree_leaves(new.params), tree_leaves(want.params)):
        assert torch.equal(a, b)
    for kind in ("prefill", "decode"):
        b = make_step_bundle(cfg, tc.ShapeConfig("p", S, B, kind))
        assert b.kind == kind and b.static_meta == {"capacity": S}


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_train_state_structs_match_init(moments):
    _, cfg = cfgs()
    lm = LM(cfg)
    opt = adamw.AdamWConfig(moments_dtype=moments)
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu")
    specs = steplib.train_state_structs(lm, opt)
    got = [(tuple(t.shape), t.dtype) for t in flatten(state)[0]]
    assert got == [(s.shape, s.dtype) for s in flatten(specs)[0]]
