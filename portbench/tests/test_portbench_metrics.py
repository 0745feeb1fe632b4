"""The metric readers on a synthetic run record: censored first tokens,
failures, gaps inside the window, counters over their span, and a trace."""
import pytest

from portbench import costs
from portbench.harness import metric_reader
from portbench.record import ClientRecord, RunRecord, TraceSummary

DIMS = costs.Dims(layers=2, d_model=8, heads=2, kv_heads=1, head_dim=4,
                  d_ff=16, vocab=32, block_size=4)


def client(due, times, limit=1.0, reason="length", error=None, plen=10):
    return ClientRecord(due=due, slo_class="interactive", ttft_limit_s=limit,
                        prompt_len=plen, max_tokens=len(times) or 1,
                        sent=due, token_times=list(times),
                        token_ids=[1] * len(times), finish_reason=reason,
                        error=error)


def record(trace=None):
    reqs = [
        client(9.0, [9.5, 10.2, 10.4]),          # due before the window
        client(10.0, [10.5, 11.0, 11.5]),        # ttft 0.5, met
        client(11.0, [13.0, 13.5]),              # ttft 2.0, missed
        client(12.0, [], reason="cut"),          # no first token: 8.0, miss
        client(13.0, [13.2], reason="aborted"),  # failed: 7.0, miss
        client(14.0, [], error="Boom"),          # failed: 6.0, miss
        client(19.0, [19.3, 20.5]),              # ttft 0.3; 2nd after close
    ]
    start = {"iterations": 0, "decode_batches": 0, "decode_tokens": 0,
             "prefill_chunks_run": 0, "decode_launch_wall_s": 0.0,
             "prefill_launch_wall_s": 0.0, "d2h_rows": 0, "h2d_rows": 0,
             "copy_launch_wall_s": 0.0, "upload_launch_wall_s": 0.0}
    end = dict(start, iterations=20, decode_batches=10, decode_tokens=45,
               prefill_chunks_run=4, decode_launch_wall_s=0.5,
               prefill_launch_wall_s=0.2, d2h_rows=30, h2d_rows=10,
               copy_launch_wall_s=1.0, upload_launch_wall_s=0.5)
    return RunRecord(dims=DIMS, w0=10.0, w1=20.0, span=(10.0, 20.0),
                     counters={"start": start, "end": end}, requests=reqs,
                     setup_s=12.5, trace=trace)


def read(name, rec):
    return metric_reader(name)(rec)


def test_ttft_counts_censored_and_failed_requests():
    """The run's printed TTFT readings: a request with no first token by
    the close counts with its wait so far; failures are failed."""
    rec = record()
    got = [r.ttft(rec.w1) for r in rec.counted()]
    assert [t for t, _ in got] == pytest.approx([0.5, 2.0, 8.0, 0.2, 6.0,
                                                 0.3])
    assert [came for _, came in got] == [True, True, False, True, False,
                                         True]
    assert [r.failed for r in rec.counted()] == [False, False, False, True,
                                                 True, False]


def test_gaps_and_tokens_count_inside_the_window_only():
    rec = record()
    # tokens received in [10, 20): 10.2, 10.4, 10.5, 11.0, 11.5, 13.0,
    # 13.5, 13.2, 19.3; gaps whose later token is inside: 0.7, 0.2, 0.5,
    # 0.5, 0.5
    assert read("output_tok_s", rec) == pytest.approx(9 / 10)
    gaps = [t - r.token_times[k - 1] for r, k, t in rec.tokens(rec.w0,
                                                               rec.w1) if k]
    assert sorted(gaps) == pytest.approx([0.2, 0.5, 0.5, 0.5, 0.7])


def test_counter_readers():
    rec = record()
    assert read("engine_iter_ms", rec) == pytest.approx(500.0)
    assert read("decode_batch", rec) == pytest.approx(4.5)
    assert read("decode_dispatch_ms", rec) == pytest.approx(50.0)
    assert read("prefill_dispatch_ms", rec) == pytest.approx(50.0)
    assert read("row_move_share", rec) == pytest.approx(15.0)
    assert read("rotated_gb_s", rec) == pytest.approx(
        40 * DIMS.row_bytes / 10 / 1e9)
    assert read("setup_s", rec) == 12.5


def test_mfu_charges_prefills_and_decode_tokens_in_the_span():
    rec = record()
    want = 0.0
    for r in rec.requests:
        for k, t in enumerate(r.token_times):
            if 10.0 <= t < 20.0:
                want += (costs.prefill_model_flops(DIMS, 10) if k == 0
                         else costs.decode_model_flops(DIMS, 10 + k))
    assert read("mfu", rec) == pytest.approx(
        100 * want / (10 * costs.H100_PEAK_BF16_FLOPS))


def test_trace_readers_and_their_silence_without_a_trace():
    rec = record()
    for name in ("idle_pct", "paged_roofline_pct"):
        assert read(name, rec) is None
    tr = TraceSummary(t0=10.0, t1=12.0, busy_s=0.5,
                      kernel_s={"paged_decode_tc_kernel<bf16>": 1e-3,
                                "flash_fwd_wg_kernel<128>": 2e-3,
                                "nvjet_gemm": 0.4},
                      idle_by_host={}, events=10)
    rec = record(tr)
    assert read("idle_pct", rec) == pytest.approx(75.0)
    f = b = 0.0
    for ctx in (11, 12, 11, 12):   # tokens 2 and 3 of the first two
        df, db = costs.decode_attention_work(DIMS, ctx)
        f, b = f + df, b + db
    assert read("paged_roofline_pct", rec) == pytest.approx(
        100 * costs.least_seconds(f, b) / 1e-3)
