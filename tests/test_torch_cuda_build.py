"""The CUDA build's cross-process lock (utils/cuda_build.build_once): of
several processes that need the same library at once, one builds it and
the others wait and load it. Runs on the CPU with a stub build in place
of nvcc."""

import multiprocessing as mp
import pathlib
import time

from software_rasterizer_tpu_torch.utils.cuda_build import build_once


def _stub_build(tmp: str, log: str) -> None:
    """A slow build: log a line, wait, write the file."""
    with open(log, "a") as f:
        f.write("built\n")
    time.sleep(1.0)
    pathlib.Path(tmp).write_bytes(b"library")


def _build_in(out: str, log: str, started, results) -> None:
    started.wait(30)
    results.put(build_once(pathlib.Path(out), pathlib.Path(out).with_suffix(".lock"),
                           lambda tmp: _stub_build(tmp, log)))


def test_one_process_builds(tmp_path):
    out, log = tmp_path / "libstub-0.so", tmp_path / "log"
    ctx = mp.get_context("spawn")
    started, results = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_build_in, args=(str(out), str(log), started, results))
             for _ in range(2)]
    for p in procs:
        p.start()
    started.set()
    built = sorted(results.get(timeout=60) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive()
    assert built == [False, True]
    assert log.read_text() == "built\n"
    assert out.read_bytes() == b"library"
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".so"] == [out.name]
    assert build_once(out, out.with_suffix(".lock"), lambda tmp: _stub_build(tmp, str(log))) is False
