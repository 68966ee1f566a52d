"""The device mesh: an ordered list of slots, each a device with a CUDA
stream of its own (counterpart of kmerdb_tpu/parallel/mesh.py, whose Mesh
has the one axis "shard").

kmerdb_tpu runs a sharded function as one SPMD program over its mesh.  Here
one process queues each slot's share under the slot's device and stream
(Mesh.run), every slot before any is waited on, so the shares of several
cards, or of several streams of one card, overlap.  The same device may
fill more than one slot: a mesh of N slots needs no N cards, only
make_mesh does.

Stream order.  A slot's stream is used inside Mesh.run and nowhere else.
On entry it waits for the device's current stream, so operands made
outside (a replicated operand, the last round's pull) are complete before
the slot reads them; on exit the device's current stream waits for every
slot's stream, so whatever follows run() (a sum of the slots' partials, a
pull, the release of an operand) is ordered after the slots' work.
"""

import contextlib
import dataclasses

import torch

from .. import _torchinit


@dataclasses.dataclass(frozen=True, eq=False)
class Slot:
    """One place of the mesh: its device and, on a CUDA device, its stream."""
    device: torch.device
    stream: "torch.cuda.Stream | None"


class Mesh:
    """Slots over `devices`, in order; a device may appear more than once."""

    def __init__(self, devices):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.slots = [Slot(d, torch.cuda.Stream(d) if d.type == "cuda"
                           else None) for d in devices]

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> list:
        """The distinct devices, in order of first use: a replicated operand
        is one tensor on each."""
        return list(dict.fromkeys(s.device for s in self.slots))

    def run(self, fn) -> list:
        """[fn(i, slot) for every slot], each queued under its slot's
        device and stream (see the module doc for the stream order)."""
        outs = []
        for i, slot in enumerate(self.slots):
            with _on(slot):
                outs.append(fn(i, slot))
        for slot in self.slots:
            if slot.stream is not None:
                torch.cuda.current_stream(slot.device).wait_stream(slot.stream)
        return outs


@contextlib.contextmanager
def _on(slot: Slot):
    if slot.stream is None:
        yield
        return
    slot.stream.wait_stream(torch.cuda.current_stream(slot.device))
    with torch.cuda.device(slot.device), torch.cuda.stream(slot.stream):
        yield


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A mesh over the first n_devices CUDA cards (default: all of them),
    one slot each."""
    devs = _torchinit.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(devs[:n_devices])
