"""The plain reference against a tiny dense GQA decoder computed directly
another way (float64, complex rotations, PyTorch's own attention), and its
gaps: zero for its own greedy tokens, positive for others."""
import torch

from portbench import costs, weights
from portbench.reference import model

DIMS = costs.Dims(layers=3, d_model=32, heads=4, kv_heads=2, head_dim=8,
                  d_ff=48, vocab=50, block_size=4)
EPS, THETA = 1e-6, 1e4


def direct_logits(w, ids):
    """Every position's logits, float64: RMSNorm by (1 + w), rotary
    embedding as a complex product of (j, j + D/2) pairs, causal softmax
    attention by scaled_dot_product_attention with each KV head repeated
    over its group, SwiGLU."""
    d64 = {k: v.double() for k, v in w["head"].items()}
    x = d64["embed"][torch.tensor(ids)]
    S, D, G = len(ids), DIMS.head_dim, DIMS.heads // DIMS.kv_heads
    freqs = THETA ** (-torch.arange(0, D, 2, dtype=torch.float64) / D)
    rot = torch.polar(torch.ones(S, D // 2, dtype=torch.float64),
                      torch.arange(S, dtype=torch.float64)[:, None] * freqs)

    def norm(v, g):
        return v / torch.sqrt((v * v).mean(-1, keepdim=True) + EPS) * (1 + g)

    def rope(t):                                   # (S, h, D)
        c = torch.complex(t[..., :D // 2], t[..., D // 2:]) * rot[:, None]
        return torch.cat([c.real, c.imag], -1)

    for p in w["layers"]:
        p = {k: v.double() for k, v in p.items()}
        a = norm(x, p["ln1"])
        q = rope(torch.einsum("sd,dhk->shk", a, p["wq"]))
        k = rope(torch.einsum("sd,dhk->shk", a, p["wk"]))
        v = torch.einsum("sd,dhk->shk", a, p["wv"])
        o = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(0, 1), k.repeat_interleave(G, 1).transpose(0, 1),
            v.repeat_interleave(G, 1).transpose(0, 1), is_causal=True)
        x = x + torch.einsum("hsk,hkd->sd", o, p["wo"])
        h = norm(x, p["ln2"])
        x = x + (torch.nn.functional.silu(h @ p["w_gate"])
                 * (h @ p["w_up"])) @ p["w_down"]
    return norm(x, d64["final_norm"]) @ d64["lm_head"]


def test_reference_matches_a_direct_computation():
    w = weights.draw(DIMS, 7, "cpu", dtype=torch.float32)
    ids = torch.randint(1, DIMS.vocab, (21,),
                        generator=torch.Generator().manual_seed(3)).tolist()
    want = direct_logits(w, ids)
    got = model._last_logits(w, EPS, THETA, ids, "cpu")
    torch.testing.assert_close(got.double(), want[-1], rtol=1e-5, atol=1e-5)
    # the served-token gaps read the same logits at every position
    prompt, served = ids[:9], ids[9:]
    gaps, ctl = model.served_gaps(w, EPS, THETA, [prompt], [served], "cpu",
                                  control=True)
    lg = want[8:20]
    want_gap = lg.max(-1).values - lg.gather(
        1, torch.tensor(served)[:, None])[:, 0]
    torch.testing.assert_close(gaps[0].double(), want_gap, rtol=1e-5,
                               atol=1e-5)
    assert ctl is not None and (ctl[0] >= 0).all()


def test_greedy_tokens_have_no_gap_and_others_do():
    w = weights.draw(DIMS, 11, "cpu", dtype=torch.float32)
    prompt = list(range(1, 13))
    toks = model.reference_tokens(w, EPS, THETA, prompt, 6, "cpu")
    gaps, _ = model.served_gaps(w, EPS, THETA, [prompt], [toks], "cpu")
    assert float(gaps[0].abs().max()) < 1e-5
    wrong = [(t + 1) % DIMS.vocab for t in toks]
    gaps, _ = model.served_gaps(w, EPS, THETA, [prompt], [wrong], "cpu")
    assert float(gaps[0][0]) > 0
