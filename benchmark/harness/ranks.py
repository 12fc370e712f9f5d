"""The ranks of a cell that renders on several cards, run from the harness's
one process: the harness's process is rank 0 and draws the frames the
window times; `Workers` spawns ranks 1 .. world - 1 (start method
"spawn", one process and one card a rank) and talks to each over a pipe.

A worker process runs `rank_main`, which loads the cell's driver by its
name (`drivers/<driver>.py`) and calls one of its functions with the
rank, the world size, the group's `file://` rendezvous, the pipe and the
driver's own arguments. That function starts the rank's process group,
answers "ready", then draws one frame for each message, answers "done",
and returns on None. A rank that raises sends ("error", traceback).

Every wait on a worker has a deadline and checks the worker's liveness:
a worker that died, failed or missed the deadline makes the wait raise,
never block. `stop()` asks every worker to return, `close()` then
kills what is left and joins every process.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback

# a wait polls each pipe this often, seconds, between liveness checks
POLL_S = 0.05


def rank_main(driver: str, entry: str, rank: int, world: int, init_method: str,
              conn, args: tuple) -> None:
    """A worker's process: the driver's `entry(rank, world, init_method,
    conn, *args)`; on an exception, ("error", traceback) to rank 0."""
    try:
        import torch

        torch.set_num_threads(1)
        from harness import discover

        getattr(discover.load_module("drivers", driver), entry)(
            rank, world, init_method, conn, *args)
    except Exception:
        try:
            conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        except OSError:     # rank 0 is gone
            pass
    finally:
        conn.close()


class Workers:
    """Ranks 1 .. world - 1 of a process group whose rank 0 is this
    process, each running `drivers/<driver>.py`'s `entry`. `init_method`
    is the group's rendezvous, a file in a temporary directory that
    `close()` removes."""

    def __init__(self, driver: str, entry: str, world: int, args: tuple = ()):
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_ranks_")
        self.init_method = "file://" + os.path.join(self._tmp.name, "rendezvous")
        self.conns, self.procs, self._stopped = [], [], False
        try:
            for rank in range(1, world):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(target=rank_main, daemon=True,
                                   args=(driver, entry, rank, world, self.init_method,
                                         theirs, args))
                proc.start()
                theirs.close()
                self.conns.append(mine)
                self.procs.append(proc)
        except BaseException:
            self.close()
            raise

    def check(self) -> None:
        """Raise if a worker has exited, closed its pipe or sent anything
        (an error) since its last answer."""
        for rank, (conn, proc) in enumerate(zip(self.conns, self.procs), 1):
            closed = False
            if conn.poll():
                try:
                    msg = conn.recv()
                except EOFError:
                    closed = True
                else:
                    self._expect(rank, msg, None)
            if closed or not proc.is_alive():
                proc.join(POLL_S)
                raise RuntimeError(f"rank {rank} exited with code {proc.exitcode}")

    def send(self, msg) -> None:
        for conn in self.conns:
            conn.send(msg)

    def wait(self, reply: str, deadline_s: float) -> None:
        """Wait for `reply` from every worker, at most `deadline_s` in all."""
        end = time.monotonic() + deadline_s
        for rank, (conn, proc) in enumerate(zip(self.conns, self.procs), 1):
            while not conn.poll(POLL_S):
                if not proc.is_alive():
                    if conn.poll():      # its last words
                        break
                    raise RuntimeError(f"rank {rank} exited with code {proc.exitcode} "
                                       f"before {reply!r}")
                if time.monotonic() > end:
                    raise TimeoutError(f"rank {rank}: no {reply!r} in {deadline_s} s")
            try:
                msg = conn.recv()
            except EOFError:
                raise RuntimeError(f"rank {rank} closed its pipe before {reply!r}") from None
            self._expect(rank, msg, reply)

    @staticmethod
    def _expect(rank: int, msg, reply) -> None:
        if isinstance(msg, tuple) and msg and msg[0] == "error":
            raise RuntimeError(f"worker failed: {msg[1]}")
        if msg != reply:
            raise RuntimeError(f"rank {rank} sent {msg!r}, expected {reply!r}")

    def stop(self) -> None:
        """Ask every worker to stop (None), once."""
        if self._stopped:
            return
        self._stopped = True
        for conn in self.conns:
            try:
                conn.send(None)
            except OSError:      # that worker is gone
                pass

    def close(self, deadline_s: float = 30.0) -> None:
        """Ask every worker to stop (unless `stop()` did), give them
        `deadline_s` in all to return, kill what is left and join every
        process."""
        self.stop()
        end = time.monotonic() + deadline_s
        for proc in self.procs:
            proc.join(max(0.0, end - time.monotonic()))
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        for conn in self.conns:
            conn.close()
        self.conns, self.procs = [], []
        self._tmp.cleanup()
