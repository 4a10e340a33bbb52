"""The tape of ``remat="save_linear"``: kernel outputs kept from a block's
forward, handed back when the backward recomputes the block.

A ``torch.utils.checkpoint`` policy sees only dispatched ATen ops, and the
NF4 matmul and flash attention launch their kernels through ctypes inside
``autograd.Function``s, so no policy can name them.  Instead each
checkpointed block gets a :class:`Tape` (``models/transformer.py``): while
the block's forward runs under :meth:`Tape.recording`, every call wrapped in
:func:`taped` keeps its output; when the backward recomputes the block under
:meth:`Tape.replaying`, the same calls, in the same order, return those
tensors and launch nothing.  The wrapped calls are the base matmul of each
block linear (``ops/qmatmul.py``, the JAX package's ``linear_out``; its
LoRA term is recomputed) and flash attention's forward, o and lse
(``ops/flash_attention.py``, JAX's ``attn_out``).  The recomputed forward
then runs only the elementwise work and the LoRA products, and builds the
graph that the kernels' backward (dx, flash dq and dk/dv) is taken through.
"""

from __future__ import annotations

_ACTIVE: list = [None]     # the tape of the block running now, if any


class _Phase:
    """Makes `tape` the active one, recording or replaying from its start;
    re-entrant, so a backward that recomputes the block again replays again."""

    def __init__(self, tape: "Tape", replay: bool):
        self.tape, self.replay = tape, replay

    def __enter__(self):
        self.prev = _ACTIVE[0]
        self.tape.replay, self.tape.next = self.replay, 0
        _ACTIVE[0] = self.tape
        return self.tape

    def __exit__(self, *exc):
        _ACTIVE[0] = self.prev
        return False


class Tape:
    """The kept outputs of one block, in call order."""

    def __init__(self):
        self.outputs: list = []
        self.replay = False
        self.next = 0

    def recording(self) -> _Phase:
        return _Phase(self, False)

    def replaying(self) -> _Phase:
        return _Phase(self, True)

    def contexts(self):
        """(forward context, recompute context), as ``checkpoint``'s
        ``context_fn`` returns them."""
        return self.recording(), self.replaying()


def _detach(out):
    return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()


def taped(compute, *args):
    """``compute(*args)`` (a tensor or a tuple of tensors), kept on the
    active tape while it records, and read back instead of computed while it
    replays; outside a tape just ``compute(*args)``."""
    tape = _ACTIVE[0]
    if tape is None:
        return compute(*args)
    if tape.replay:
        if tape.next >= len(tape.outputs):
            raise RuntimeError("remat='save_linear': the recomputed block asks for more "
                               "kept outputs than its forward made")
        out = tape.outputs[tape.next]
        tape.next += 1
        return _detach(out)
    out = compute(*args)
    tape.outputs.append(_detach(out))
    return out

