"""The sink that each timed call writes its CSV into: a FIFO read by a
child process, so that no output reaches the disk.

The child reads every byte of one writer's session into one reused
buffer, takes its CRC-32 (a check against faults, not against an
adversary), counts its lines and keeps the lines whose numbers it was given
(0 is the header, 1 the totals row, 2 + i sample i's row).  At the writer's
end of file it prints one JSON line and waits for the next writer, until it
is ended.  It keeps to one core, the last that it may use, so that it takes
as little as it can from the writer on a shared host: per chunk it makes no
copy but of the chunks that hold a kept line.

``python portbench/sink.py <fifo> <line>,<line>,...`` runs the child.
"""

from __future__ import annotations

import fcntl
import json
import os
import subprocess
import sys
import tempfile
import zlib

CHUNK = 1 << 20
F_SETPIPE_SZ = 1031          # fcntl.F_SETPIPE_SZ, named only from 3.10 on


def _session(fd: int, wanted: list, buf: bytearray) -> dict:
    """Reads one writer's bytes to its end of file.  wanted: the line
    numbers to keep, ascending; buf: the read buffer."""
    view = memoryview(buf)
    crc = 0
    n_bytes = 0
    line_no = 0                  # the line that the next byte belongs to
    wi = 0                       # the next wanted line, wanted[wi]
    kept: dict = {}
    partial = b""                # the start of a wanted line
    while True:
        got = os.readv(fd, [buf])
        if not got:
            break
        crc = zlib.crc32(view[:got], crc)
        n_bytes += got
        nl = buf.count(b"\n", 0, got)
        if wi < len(wanted) and wanted[wi] <= line_no + nl:
            parts = bytes(view[:got]).split(b"\n")
            for j, part in enumerate(parts[:-1]):
                if wi < len(wanted) and wanted[wi] == line_no + j:
                    kept[line_no + j] = (partial + part).decode("ascii")
                    wi += 1
                partial = b""
            if wi < len(wanted) and wanted[wi] == line_no + nl:
                partial += parts[-1]
        line_no += nl
    return {"crc32": crc, "bytes": n_bytes, "lines": line_no,
            "kept": {str(k): v for k, v in kept.items()},
            "unterminated": bool(partial)}


def _one_core() -> None:
    """Keeps this process to the last core it may use, where it has more
    than one."""
    try:
        cores = os.sched_getaffinity(0)
        if len(cores) > 1:
            os.sched_setaffinity(0, {max(cores)})
    except (AttributeError, OSError):
        pass                     # no affinity here: run where scheduled


def serve(fifo: str, wanted: list) -> None:
    _one_core()
    buf = bytearray(CHUNK)
    while True:
        fd = os.open(fifo, os.O_RDONLY)
        try:
            try:
                fcntl.fcntl(fd, F_SETPIPE_SZ, 1 << 20)
            except OSError:
                pass             # the system's pipe-size limit is lower
            report = _session(fd, wanted, buf)
        finally:
            os.close(fd)
        sys.stdout.write(json.dumps(report) + "\n")
        sys.stdout.flush()


class Sink:
    """A FIFO in the temporary directory and the child that drains it.
    path is the output file to give a call; report() waits for that call's
    JSON line."""

    def __init__(self, wanted_lines):
        self.dir = tempfile.mkdtemp(prefix="portbench-sink-")
        self.path = os.path.join(self.dir, "out.csv")
        os.mkfifo(self.path)
        lines = ",".join(str(w) for w in sorted(wanted_lines))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.path, lines],
            stdout=subprocess.PIPE, text=True)

    def report(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the sink ended without a report")
        return json.loads(line)

    def close(self) -> None:
        """Ends the child (it holds nothing to flush) and removes the
        FIFO."""
        try:
            self.proc.terminate()
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self.proc.stdout.close()
            os.unlink(self.path)
            os.rmdir(self.dir)


if __name__ == "__main__":
    serve(sys.argv[1], sorted({int(w) for w in sys.argv[2].split(",") if w}))
