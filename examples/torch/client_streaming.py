"""Client-facing streaming API demo: two concurrent requests in different
SLO classes stream tokens from one engine; one is aborted mid-stream and the
engine's free-block count returns to its pre-submission value.

The port of ``examples/client_streaming.py``: the host layer (engine,
scheduler, block table) on the GH200 model's clock; nothing is placed on
a device.

    PYTHONPATH=src python examples/torch/client_streaming.py

What this shows (DESIGN.md §API layer):

  * ``engine.add_request(prompt_len=..., sampling_params=..., slo_class=...)``
    returns a ``RequestHandle`` — no pre-built oracle Request dataclass.
  * Handles are pull-based: polling ``handle.events()`` while stepping the
    engine interleaves two live token streams from one thread;
    ``handle.stream()`` is the single-stream convenience wrapper.
  * ``handle.abort()`` cancels mid-stream: HBM/DRAM blocks are freed
    immediately, the final event carries ``finish_reason == "aborted"``.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import (GH200, ServingConfig,  # noqa: E402
                                 get_config)
from repro_torch.core.types import SamplingParams  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def main():
    cfg = get_config("qwen2.5-32b")
    sv = ServingConfig(num_hbm_blocks=2000, num_dram_blocks=20000,
                       scheduler="rotasched")
    eng = ServingEngine(cfg, sv, GH200)
    hbm0, dram0 = eng.kv.hbm_free_blocks, eng.kv.table.dram_free
    print(f"engine up: {hbm0} HBM blocks free, {dram0} DRAM blocks free")

    # -- two concurrent requests, different SLO tiers -------------------------
    chat = eng.add_request(prompt_len=512,
                           sampling_params=SamplingParams(max_tokens=48),
                           slo_class="interactive")
    bulk = eng.add_request(prompt_len=2048,
                           sampling_params=SamplingParams(max_tokens=400),
                           slo_class="batch")
    print(f"submitted: req {chat.req_id} (interactive/48 tok), "
          f"req {bulk.req_id} (batch/400 tok)")

    # drive both streams from one loop: step the engine, poll both handles
    aborted = False
    while eng.has_work and not (chat.finished and bulk.finished):
        eng.step()
        for h, tag in ((chat, "chat"), (bulk, "bulk")):
            for out in h.events():
                if out.new_tokens:
                    print(f"  t={out.t:7.3f}s [{tag}] +{out.new_tokens} tok "
                          f"({out.tokens_generated} total, "
                          f"ttft={out.ttft_s:.3f}s)")
                if out.finished:
                    print(f"  t={out.t:7.3f}s [{tag}] finished: "
                          f"{out.finish_reason}")
        # cancel the bulk request mid-stream once the chat one is done
        if chat.finished and not aborted and not bulk.finished:
            print(f"  -- aborting bulk req {bulk.req_id} at "
                  f"{bulk.request.tokens_generated} tokens --")
            bulk.abort()
            aborted = True

    for out in bulk.events():       # the abort's final event
        if out.finished:
            print(f"  t={out.t:7.3f}s [bulk] finished: {out.finish_reason}")

    assert chat.request.finish_reason == "length"
    assert bulk.request.finish_reason == "aborted"
    assert eng.stats.aborted == 1

    # abort + finish freed every block: pool back to pre-submission state
    hbm1, dram1 = eng.kv.hbm_free_blocks, eng.kv.table.dram_free
    print(f"pool after: {hbm1} HBM free, {dram1} DRAM free")
    assert hbm1 == hbm0, f"HBM leak: {hbm0 - hbm1} blocks"
    assert dram1 == dram0, f"DRAM leak: {dram0 - dram1} blocks"

    print("chat metrics:", chat.metrics())
    print("bulk metrics:", bulk.metrics())

    # -- stream() generator: the single-request convenience path --------------
    h = eng.add_request(prompt_len=256,
                        sampling_params=SamplingParams(max_tokens=8),
                        slo_class="standard")
    toks = [out.new_tokens for out in h.stream()]
    print(f"stream() pulled {sum(toks)} tokens in {len(toks)} events; "
          f"final reason: {h.request.finish_reason}")
    assert sum(toks) == 8

    rep = eng.report()
    print(f"report: n={rep.n} aborted={rep.n_aborted} "
          f"per-class={sorted(rep.per_class)}")
    print("free-block pool restored after mid-stream abort ✓")


if __name__ == "__main__":
    main()
