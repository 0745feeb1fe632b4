"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``), in process, with the same flags: the
sim-mode JSON report is equal, exactly, for the golden flags alone and
with the router, disaggregation and the int8 tier's byte budget; a
flight-recorder run writes a Perfetto trace with the same events. Plus the
launcher's refusals: a ``--tp`` that does not divide the kv heads, and
``--paged-runner`` with no CUDA device and no ``--device cpu``."""
import collections
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as rserve  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402

GOLDEN = ["--rps", "20", "--duration", "40", "--seed", "0", "--json"]


def report(main, argv, capsys):
    row = main(argv)
    out = capsys.readouterr().out
    assert json.loads(out) == json.loads(json.dumps(row))
    return out


@pytest.mark.parametrize("extra", [
    [],
    ["--replicas", "2", "--router", "slo-aware"],
    ["--disagg"],
    ["--kv-dtype", "int8", "--hbm-budget-gb", "60"],
], ids=["golden", "router", "disagg", "int8-budget"])
def test_sim_report_equals_reference(extra, capsys):
    want = report(rserve.main, GOLDEN + extra, capsys)
    got = report(tserve.main, GOLDEN + extra, capsys)
    assert got == want
    row = json.loads(got)
    assert row["n"] > 0
    if "--disagg" in extra:
        assert row["disagg"] and row["migration"]["migrations"] > 0
    if "--replicas" in extra:
        assert len(row["per_replica"]) == 2
    if "int8" in extra:
        assert row["kv_dtype"] == "int8"


def test_trace_out_equals_reference(tmp_path, capsys):
    """The flight recorder and the Perfetto export: the same report (bar
    the trace path) and the same trace, event for event."""
    argv = ["--rps", "20", "--duration", "10", "--seed", "0", "--json",
            "--telemetry", "--trace-out"]
    want = json.loads(report(rserve.main, argv + [str(tmp_path / "r.json")],
                             capsys))
    got = json.loads(report(tserve.main, argv + [str(tmp_path / "t.json")],
                            capsys))
    assert got.pop("trace_out") == str(tmp_path / "t.json")
    want.pop("trace_out")
    assert got == want
    assert got["telemetry"]["spans"] > 0 and got["telemetry"]["events"] > 0
    rt = json.loads((tmp_path / "r.json").read_text())
    tt = json.loads((tmp_path / "t.json").read_text())

    def names(trace):
        return collections.Counter((e["ph"], e["name"])
                                   for e in trace["traceEvents"])

    assert names(tt) == names(rt)
    assert len(names(tt)) > 4
    assert tt == rt


def test_launcher_refusals():
    # --tp is ported: a degree the default config (qwen2.5-32b, Hkv=8)
    # cannot shard raises the reference's error naming the field
    with pytest.raises(ValueError, match="num_kv_heads"):
        tserve.main(["--tp", "3", "--device", "cpu", "--rps", "1",
                     "--duration", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--paged-runner", "--rps", "1", "--duration", "1"])
