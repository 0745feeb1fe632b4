"""The port's in-place audit (``repro_torch/launch/audit_donation.py``) on
the CPU against the reference's donation audit: ``main(["--device",
"cpu"])`` exits 0; its launch entries, mapped to the reference's jit
boundaries, carry the same verdicts as the reference's ``main()`` (tp=1;
one XLA device here); the out-of-place negative control reads "not in
place" and counts as expected; and an entry made out of place by a patch
(its store's pool replaced by a copy before the call) fails the audit
and makes ``main`` exit 1."""
import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.launch import audit_donation  # noqa: E402
from repro_torch.serving.paged_runner import (PagedKVStore,  # noqa: E402
                                              PagedModelRunner)


def run_main(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def reference():
    """(rc, [(jit boundary, verdict)]) of the reference's audit."""
    jax.devices()       # one XLA device: the tp=2 boundaries are skipped
    from repro.launch.audit_donation import main
    rc, out = run_main(main, [])
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("jit boundary")) + 1
    rows = [(ln[:48].rstrip(), ln.split()[-1]) for ln in lines[start:]
            if ln and not ln.startswith("#")]
    return rc, rows


@pytest.fixture(scope="module")
def port_rows():
    return audit_donation.audit(*audit_donation.small_config(), "cpu")


def test_main_on_cpu_exits_0():
    rc, out = run_main(audit_donation.main, ["--device", "cpu"])
    assert rc == 0, out
    assert "# audit ok" in out and "item 3" in out
    assert out.splitlines()[0].split()[:2] == ["launch", "entry"]


def test_entries_and_verdicts_match_reference(reference, port_rows):
    rc, ref_rows = reference
    assert rc == 0
    assert len(ref_rows) == 9
    assert [(r.reference, r.verdict) for r in port_rows] == ref_rows


def test_entries_in_place_on_every_buffer(port_rows):
    for r in port_rows[:-1]:
        assert r.ok and r.in_place == r.found, r
        assert r.found == (2 if "[int8]" in r.name else 1)
        assert r.growth is None          # measured on CUDA only


def test_negative_control_is_not_in_place(port_rows):
    ctl = port_rows[-1]
    assert "negative control" in ctl.name
    assert ctl.found == 1 and ctl.in_place == 0 and ctl.ok


def _out_of_place(cls, meth):
    orig = getattr(cls, meth)

    def wrapped(self, *a, **kw):
        store = self if isinstance(self, PagedKVStore) else self.store
        store.pool = store.pool.clone()       # the write goes to a copy
        return orig(self, *a, **kw)
    return wrapped


@pytest.mark.parametrize("cls,meth,failing", [
    # run_h2d scatters through _copy_rows, so both fail
    (PagedKVStore, "_copy_rows", ["PagedKVStore._copy_rows",
                                  "PagedKVStore.run_h2d (upload)"]),
    (PagedKVStore, "run_h2d", ["PagedKVStore.run_h2d (upload)"]),
    (PagedModelRunner, "_decode", ["PagedModelRunner._decode"]),
    (PagedModelRunner, "_prefill", ["PagedModelRunner._prefill"]),
], ids=["copy_rows", "run_h2d", "decode", "prefill"])
def test_out_of_place_entry_fails(cls, meth, failing, monkeypatch):
    monkeypatch.setattr(cls, meth, _out_of_place(cls, meth))
    rows = audit_donation.audit(*audit_donation.small_config(), "cpu")
    want = failing + [f + " [int8]" for f in failing]
    assert sorted(r.name for r in rows if not r.ok) == sorted(want)
    rc, out = run_main(audit_donation.main, ["--device", "cpu"])
    assert rc == 1 and "FAIL" in out
