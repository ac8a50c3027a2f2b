"""Gloo worlds of worker subprocesses, for the port's multi-process tests.

A world's ranks meet at rank 0's TCP store through COORDINATOR_ADDRESS, as
the CLI's ranks do, on a port that `free_port` found free. Between that
check and rank 0's bind another process can take the port (the world of a
test running beside it), and rank 0 then fails with EADDRINUSE. `World`
starts the processes of one world on ports of their own; when one of them
fails with EADDRINUSE it kills the others and starts the whole world again
on new ports, at most `ATTEMPTS` times in all.
"""
import socket
import subprocess
import tempfile
import time

ATTEMPTS = 3
_IN_USE = ("eaddrinuse", "address already in use")


def free_port() -> int:
    """A port that no process listens on now (it may be taken later)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def in_use(stderr: str) -> bool:
    """Whether a process's standard error shows a bind that found its port
    taken."""
    return any(m in stderr.lower() for m in _IN_USE)


class World:
    """The processes of one world, started at once.

    argv(ports) gives the command line of every process from the world's
    `n_ports` ports (strings); prepare(), when given, runs before every
    start: it makes the world's files anew, so that a killed attempt's
    files (a half-written checkpoint) never reach the next one."""

    def __init__(self, argv, n_ports=1, env=None, prepare=None):
        self.argv, self.n_ports, self.env, self.prepare = argv, n_ports, env, prepare
        self.attempts = 0
        self.procs, self.files = [], []
        self.start()

    def start(self):
        self.attempts += 1
        if self.prepare is not None:
            self.prepare()
        ports = [str(free_port()) for _ in range(self.n_ports)]
        self.procs, self.files = [], []
        for cmd in self.argv(ports):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            self.procs.append(subprocess.Popen(cmd, env=self.env, stdout=out, stderr=err,
                                               text=True))
            self.files.append((out, err))

    def kill(self):
        """Stop every process that still runs."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    @staticmethod
    def _read(f) -> str:
        f.seek(0)
        return f.read()

    def wait(self, timeout: float):
        """Every process's standard output, once all have exited with 0;
        a world that failed with EADDRINUSE is started again. Raises
        AssertionError (every process stopped) when a process fails
        otherwise, with the end of its standard error, or when the world
        runs past `timeout` seconds from this call or from its restart."""
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in self.procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                errs = [self._read(self.files[i][1]) for i in failed]
                self.kill()
                if any(in_use(e) for e in errs) and self.attempts < ATTEMPTS:
                    self.start()
                    deadline = time.monotonic() + timeout
                    continue
                raise AssertionError(f"process {failed[0]} of the world exited with "
                                     f"{codes[failed[0]]} (attempt {self.attempts}):\n"
                                     f"{errs[0][-3000:]}")
            if all(c == 0 for c in codes):
                return [self._read(out) for out, _ in self.files]
            if time.monotonic() > deadline:
                self.kill()
                raise AssertionError(f"a process of the world ran past {timeout} s")
            time.sleep(0.2)
