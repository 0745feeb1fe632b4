"""The harness's run on the CPU at a tiny size: a sound run is correct, its
fp8 control and every fault a serving cell can have are not, and a cell,
a mix and a metric added as files are picked up with no code edited."""
import dataclasses
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny_root
from repro_torch.serving.paged_runner import PagedModelRunner

SECONDS = 2.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        tiny_root.patch_registry(mp)
        yield tiny_root.make(tmp_path_factory.mktemp("bench"),
                             extra_metric="due_count")


def run(root, seed, **kw):
    return harness.run_cell(tiny_root.WORKLOAD, seed, SECONDS, False, "cpu",
                            time.monotonic(), root=root, **kw)


def test_sound_run_is_correct_and_its_fp8_control_is_not(root):
    cell = harness.load_cell(tiny_root.WORKLOAD, root)
    out = run(root, 3, control=True)
    correct, nums = harness.verdict(cell, out)
    assert correct, nums
    assert out.check["served_tokens"] >= cell.check["check_tokens_min"]
    correct, nums = harness.verdict(cell, harness.control_outcome(out))
    assert not correct, nums
    assert nums["widest_gap"]["value"] > cell.check["gap_limit"]


def test_program_int8_tier_departs_from_the_cell(root):
    """The program's own lower-precision path, its int8 KV tier, serving a
    bf16 cell is not correct whatever its gaps."""
    cell = harness.load_cell(tiny_root.WORKLOAD, root)
    sv = dataclasses.replace(harness.serving_config(cell), kv_dtype="int8")
    out = run(root, 4, sv=sv)
    correct, nums = harness.verdict(cell, out)
    assert not correct, nums
    assert nums["kv_dtype_departures"]["value"] > 0


def test_cell_that_needs_a_rotated_request_fails_without_one(root):
    """A cell whose check asks for a request rotated out and back is not
    correct when the sample holds none, however small its gaps."""
    cell = harness.load_cell(tiny_root.WORKLOAD, root)
    out = run(root, 6)
    need = dataclasses.replace(cell, check=dict(
        cell.check, rotated_back_min=out.sample_rotated + 1))
    assert harness.verdict(cell, out)[0]
    correct, nums = harness.verdict(need, out)
    assert not correct, nums


def test_new_cell_mix_and_metric_need_no_code(root):
    """The tiny cell, its mix and the ``due_count`` reader exist only as
    files and entries; the harness reports the metric in a traced run's
    list and reads it from the run's record."""
    names = [m["name"] for m in harness.cell_metrics(tiny_root.WORKLOAD,
                                                     True, root)]
    assert "due_count.tok" in names
    out = run(root, 5)
    read = harness.metric_reader("due_count", root)
    assert read(out.rec) == len(out.rec.counted()) > 0
    for m in harness.cell_metrics(tiny_root.WORKLOAD, False, root):
        assert harness.metric_reader(m["name"].split(".")[0], root)(
            out.rec) is not None, m["name"]


def _half_batch(orig):
    def run_decode_batch(self, dec):
        k = max(len(dec) // 2, 1)
        top = orig(self, dec[:k])
        return top[torch.arange(len(dec)) % k]
    return run_decode_batch


def _altered_token(orig):
    def top2(self, h):
        t = orig(self, h).clone()
        t[..., 0] = (t[..., 0] + 1) % self.cfg.vocab_size
        return t
    return top2


FAULTS = {
    # a step that leaves its state unchanged: no K/V reaches the pool
    "state_unchanged": ("_store_kv", lambda orig: lambda *a, **k: None),
    # half of the decode batch left out, the rest given others' tokens
    "half_batch": ("_run_decode_batch", _half_batch),
    # a token altered where it is produced
    "token_altered": ("_top2", _altered_token),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_timed_path_is_not_correct(root, monkeypatch, fault):
    name, make = FAULTS[fault]
    monkeypatch.setattr(PagedModelRunner, name,
                        make(getattr(PagedModelRunner, name)))
    cell = harness.load_cell(tiny_root.WORKLOAD, root)
    out = run(root, 2)
    correct, nums = harness.verdict(cell, out)
    assert not correct, nums
    assert out.check["widest_gap"] > cell.check["gap_limit"]
