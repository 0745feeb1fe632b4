"""The port's serving CLI with real execution: ``--paged-runner --device cpu
--kv-dtype int8`` at smoke scale against the reference CLI's
``--paged-runner --kv-dtype int8`` with the same flags. The two packages
draw their random weights differently (a ``torch.Generator`` against
``jax.random``), so the token ids differ; what the scheduler and the KV
tiers decide does not depend on them, so every count in the report —
requests, decoded tokens, launches, rows moved, bytes, attainment — is
equal, and only the host wall-clock fields differ."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as rserve  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402

ARGV = ["--paged-runner", "--kv-dtype", "int8", "--rps", "2", "--duration",
        "2", "--seed", "0", "--json"]
WALL_CLOCK = ("prefill_launch_wall_s", "decode_launch_wall_s",
              "kv_copy_launch_wall_s")


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_paged_int8_cli_counts_equal_reference(capsys):
    want = rserve.main(ARGV)
    got = tserve.main(ARGV + ["--device", "cpu"])
    capsys.readouterr()
    for row in (want, got):
        for k in WALL_CLOCK:
            assert row.pop(k) >= 0
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["paged_runner"] and got["kv_dtype"] == "int8"
    assert got["decode_tokens"] > 0 and got["attn_launches"] > 0
