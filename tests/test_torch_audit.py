"""The port's in-place audit (``repro_torch/launch/audit_donation.py``) on
the CPU against the reference's donation audit: ``main(["--device",
"cpu"])`` exits 0; its launch entries, mapped to the reference's jit
boundaries, carry the same verdicts as the reference's ``main()`` (tp=1
in process, on one XLA device; tp=2 too in a subprocess with two forced
XLA host devices); the out-of-place negative control reads "not in
place" and counts as expected; and an entry made out of place by a patch
(its store's pool replaced by a copy before the call, shard 0's or, at
tp=2, shard 1's) fails the audit and makes ``main`` exit 1."""
import contextlib
import io
import os
import pathlib
import subprocess
import sys

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


ROOT = pathlib.Path(__file__).resolve().parents[1]


def verdicts(out):
    """[(jit boundary, verdict)] of the reference audit's table."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("jit boundary")) + 1
    return [(ln[:48].rstrip(), ln.split()[-1]) for ln in lines[start:]
            if ln and not ln.startswith("#")]


@pytest.fixture(scope="module")
def reference():
    """(rc, [(jit boundary, verdict)]) of the reference's audit."""
    jax.devices()       # one XLA device: the tp=2 boundaries are skipped
    from repro.launch.audit_donation import main
    rc, out = run_main(main, [])
    return rc, verdicts(out)


# A sharded lowering's pool argument as this jax writes it: Shardy's
# sharding attribute, whose braces nest, comes before the donation marker.
SHARDED_ARG = ('%arg0: tensor<73x4x2x4x2x16xf32> {sdy.sharding = '
               '#sdy.sharding<@mesh, [{}, {}, {}, {}, {"model"}, {}]>, '
               'tf.aliasing_output = 0 : i32}')
# the reference's _ALIAS_RE with one level of nested braces allowed in the
# argument's attributes
NESTED_ALIAS_RE = (r"%arg\d+: tensor<([0-9x]+)x[a-z0-9]+>\s*"
                   r"(\{(?:[^{}]|\{[^{}]*\})*"
                   r"(?:tf\.aliasing_output|jax\.buffer_donor)"
                   r"(?:[^{}]|\{[^{}]*\})*\})?")


def test_reference_alias_regex_misses_sharded_donation():
    """The reference's audit reads the donation marker with a regex whose
    attribute group stops at the first '}': on a Shardy-annotated
    (sharded) argument it finds the pool but not its marker, so its tp=2
    rows print FAIL though the lowering donates the pool (ROADMAP.md §3).
    The nested-brace form reads it; on an unsharded argument both agree."""
    import re
    from repro.launch.audit_donation import _ALIAS_RE
    plain = "%arg0: tensor<73x4x2x4x2x16xf32> {tf.aliasing_output = 0 : i32}"
    assert _ALIAS_RE.findall(SHARDED_ARG) == [("73x4x2x4x2x16", "")]
    fixed = re.compile(NESTED_ALIAS_RE)
    assert fixed.findall(SHARDED_ARG)[0][1].endswith("0 : i32}")
    assert fixed.findall(plain) == _ALIAS_RE.findall(plain)


@pytest.fixture(scope="module")
def reference_tp2():
    """The reference's audit with two XLA host devices, forced before jax
    loads (a subprocess): its tp=2 boundaries too, read with the
    nested-brace regex (the test above)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"),
                               os.environ.get("PYTHONPATH")) if p))
    code = ("import re, sys\n"
            "from repro.launch import audit_donation as a\n"
            f"a._ALIAS_RE = re.compile({NESTED_ALIAS_RE!r})\n"
            "sys.exit(a.main([]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, verdicts(proc.stdout)


@pytest.fixture(scope="module")
def port_rows():
    return audit_donation.audit(*audit_donation.small_config(), "cpu")


@pytest.fixture(scope="module")
def port_rows_tp2():
    return audit_donation.audit(*audit_donation.small_config(), "cpu",
                                tp2=["cpu", "cpu"])


def test_main_on_cpu_exits_0():
    rc, out = run_main(audit_donation.main, ["--device", "cpu"])
    assert rc == 0, out
    assert "# audit ok" in out and "# tp=2 shards on: cpu, cpu" in out
    assert sum("[tp=2]" in ln for ln in out.splitlines()) == 8
    assert out.splitlines()[0].split()[:2] == ["launch", "entry"]


def test_tp2_entries_and_verdicts_match_reference(reference_tp2,
                                                  port_rows_tp2):
    rc, ref_rows = reference_tp2
    assert rc == 0
    assert len(ref_rows) == 17
    assert [(r.reference, r.verdict) for r in port_rows_tp2] == ref_rows


def test_tp2_entries_in_place_on_every_shard(port_rows_tp2):
    tp2 = [r for r in port_rows_tp2 if "[tp=2]" in r.name]
    assert len(tp2) == 8
    for r in tp2:
        # both shards' pools, and their scales in the int8 tier
        assert r.ok and r.found == (4 if "[int8]" in r.name else 2), r
        assert r.in_place == r.found


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


def test_out_of_place_shard_fails_at_tp2(monkeypatch):
    """A row copy that writes to a copy of shard 1's pool fails the tp=2
    entries that move rows (the copy and the upload, which scatters
    through it) and no tp=1 entry."""
    orig = PagedKVStore._copy_rows

    def wrapped(self, *a, **kw):
        if len(self.pools) == 2:
            self.pools[1] = self.pools[1].clone()
        return orig(self, *a, **kw)

    monkeypatch.setattr(PagedKVStore, "_copy_rows", wrapped)
    rows = audit_donation.audit(*audit_donation.small_config(), "cpu",
                                tp2=["cpu", "cpu"])
    assert sorted(r.name for r in rows if not r.ok) == sorted(
        ["PagedKVStore._copy_rows [tp=2]",
         "PagedKVStore.run_h2d (upload) [tp=2]",
         "PagedKVStore._copy_rows [tp=2] [int8]",
         "PagedKVStore.run_h2d (upload) [tp=2] [int8]"])
