"""The port's host-only copies against the reference's: ``utils.sched`` on
the cases of tests/test_utils.py, and the ``verify_minnow`` and
``print_all_names`` CLIs giving the reference's output on the same
files.  Tolerance zero: the same lists, lines and exit codes."""

import numpy as np
import pytest

from minnow_tpu.cli import print_all_names as jax_print_all_names
from minnow_tpu.cli import verify_minnow as jax_verify_minnow
from minnow_tpu.formats import minh
from minnow_tpu.utils import sched as jax_sched
from minnow_torch.cli import print_all_names, verify_minnow
from minnow_torch.utils import sched


def _calls(mod, jobs, workers, strategy):
    """Every ``work(worker, start, end, step)`` call of a split, sorted."""
    out = []
    mod.split_array(jobs, workers, lambda *a: out.append(a), strategy)
    return sorted(out)


@pytest.mark.parametrize("workers", [1, 2, 3, 49, 100, 1000])
@pytest.mark.parametrize("strategy", ["contiguous", "jump"])
def test_split_array_matches_reference_and_serial_sum(workers, strategy):
    x = np.arange(10_000)
    parts = np.zeros(workers, dtype=np.int64)

    def work(w, start, end, step):
        parts[w] += x[start:end:step].sum()

    sched.split_array(len(x), workers, work, strategy)
    assert parts.sum() == x.sum()
    assert _calls(sched, len(x), workers, strategy) == \
        _calls(jax_sched, len(x), workers, strategy)


@pytest.mark.parametrize("workers,jobs", [(7, 257), (1, 5), (4, 1), (3, 0)])
def test_worker_queue_runs_every_job_once(workers, jobs):
    done = np.zeros(jobs, dtype=np.int64)
    seen = []

    def work(w, j):
        done[j] += 1
        seen.append(w)

    sched.worker_queue(workers, jobs, work)
    assert (done == 1).all()
    assert all(0 <= w < max(workers, 1) for w in seen)


def test_worker_queue_raises_a_job_s_error():
    def work(w, j):
        if j == 3:
            raise KeyError("job 3")

    with pytest.raises(KeyError, match="job 3"):
        sched.worker_queue(4, 8, work)


def test_split_array_bad_strategy():
    with pytest.raises(ValueError, match="Unknown strategy"):
        sched.split_array(4, 2, lambda *a: None, "weighted")
    with pytest.raises(ValueError, match="one weight per job"):
        sched.split_array(4, 2, lambda *a: None,
                          sched.weighted_contiguous([1.0, 2.0]))


@pytest.mark.parametrize("seed", range(4))
def test_weighted_contiguous_matches_reference(seed):
    rng = np.random.default_rng(seed)
    jobs, workers = 100, int(rng.integers(1, 12))
    weights = rng.uniform(0.1, 10, jobs)
    assert sched.weighted_bounds(weights, workers) == \
        jax_sched.weighted_bounds(weights, workers)
    assert sched.weighted_contiguous(weights) == \
        jax_sched.weighted_contiguous(weights)
    assert (sched.contiguous(), sched.jump()) == \
        (jax_sched.contiguous(), jax_sched.jump())
    strategy = sched.weighted_contiguous(weights)
    calls = _calls(sched, jobs, workers, strategy)
    assert calls == _calls(jax_sched, jobs, workers, strategy)
    covered = sorted(i for _, lo, hi, step in calls
                     for i in range(lo, hi, step))
    assert covered == list(range(jobs))


def _write_catalog(fname, rng, lens=(10,)):
    """The catalog of tests/test_minh_device.py."""
    cols = [minh.Column(type=minh.Int),
            minh.Column(type=minh.Float, low=0, high=250, dx=0.01),
            minh.Column(type=minh.Float, log=1, low=5, high=16, dx=0.001)]
    w = minh.create(fname)
    w.header(["id", "x", "mvir"], "t", cols)
    w.geometry(250, 0, 0)
    for n in lens:
        w.block([rng.integers(0, 10**12, n),
                 rng.uniform(0, 249.9, n).astype(np.float32),
                 (10.0 ** rng.uniform(5.5, 15.5, n)).astype(np.float32)])
    w.close()


@pytest.fixture
def files(tmp_path):
    """A valid minh file, a crashed writer's (zero header), one cut short
    in its tail, one cut below the header, and one with a wrong magic."""
    ok = tmp_path / "ok.minh"
    _write_catalog(str(ok), np.random.default_rng(2), lens=(10, 37))
    data = ok.read_bytes()
    out = {"ok": ok}
    for name, raw in (("crashed", b"\0" * 48 + data[48:]),
                      ("trunc", data[:len(data) - 10]),
                      ("tiny", data[:20]),
                      ("magic", b"\x01" + data[1:]),
                      ("version", data[:8] + b"\x07" + data[9:]),
                      ("tail", data[:40] + b"\xff" * 7 + b"\x7f"
                       + data[48:])):
        out[name] = tmp_path / (name + ".minnow")
        out[name].write_bytes(raw)
    return out


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("name", ["ok", "crashed", "trunc", "tiny", "magic",
                                  "version", "tail"])
def test_verify_gives_the_reference_s_problems(files, name, deep):
    fname = str(files[name])
    got = verify_minnow.verify(fname, deep=deep)
    assert got == jax_verify_minnow.verify(fname, deep=deep)
    assert (got == []) == (name == "ok")
    if name == "crashed":
        assert any("never closed" in p for p in got)


@pytest.mark.parametrize("seed", range(12))
def test_verify_of_corrupt_files_matches_reference(tmp_path, seed):
    """Random byte flips of a valid file (tests/test_fuzz.py): the same
    list of problems, and never an exception."""
    rng = np.random.default_rng(seed)
    ok = tmp_path / "victim.minh"
    _write_catalog(str(ok), rng, lens=(50,))
    raw = bytearray(ok.read_bytes())
    for _ in range(int(rng.integers(1, 12))):
        raw[int(rng.integers(0, len(raw)))] ^= int(rng.integers(1, 256))
    bad = tmp_path / "corrupt.minh"
    bad.write_bytes(bytes(raw))
    got = verify_minnow.verify(str(bad), deep=True)
    assert isinstance(got, list)
    assert got == jax_verify_minnow.verify(str(bad), deep=True)


@pytest.mark.parametrize("names,code", [(["ok"], 0), (["ok", "crashed"], 1),
                                        (["trunc", "--deep"], 1)])
def test_verify_main_prints_and_exits_as_the_reference(files, capsys, names,
                                                       code):
    argv = [str(files[n]) if n in files else n for n in names]
    outs = []
    for mod in (verify_minnow, jax_verify_minnow):
        with pytest.raises(SystemExit) as e:
            mod.main(list(argv))
        assert e.value.code == code
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert ("INVALID" in outs[0]) == bool(code)
    with pytest.raises(SystemExit, match="verify_minnow"):
        verify_minnow.main([])


@pytest.mark.parametrize("with_index", [False, True])
def test_print_all_names_prints_what_the_reference_prints(tmp_path, capsys,
                                                          with_index):
    (tmp_path / "a_1.list").write_text(
        "#ID Mvir X Strange\n1 1e10 0.5 3\n")
    (tmp_path / "b_2.list").write_text("#ID PID X Mvir\n2 -1 0.25 1e11\n")
    index = tmp_path / "names.txt"
    index.write_text("id ID\npid PID\nx X\nmvir Mvir M200\n")
    argv = [str(tmp_path / "*.list")] + ([str(index)] if with_index else [])
    print_all_names.main(list(argv))
    got = capsys.readouterr().out
    jax_print_all_names.main(list(argv))
    assert got == capsys.readouterr().out
    assert len(got.splitlines()) == 5
    assert ("[NOT IN INDEX]" in got) == with_index
    with pytest.raises(SystemExit, match="print_all_names"):
        print_all_names.main([])
