"""Deterministic chaos harness for the serving engine (PyTorch port of
`repro/runtime/chaos.py`).

Faults fire at fixed chunk indices (the engine's dispatch counter, not
wall time), and every corruption is a pure function of its event: same
spec, same trace, same failure. That is what lets recovery be held to
bit-equality: a chaos run that detects, drains, remaps and hot-reprograms
before the next chunk dispatches emits the unfaulted run's tokens.

Two fault kinds, both applied at a chunk boundary by
`ServeEngine._resilience_tick`:

  * ``kill``    — a core (context) dies: every matrix on it reads as a dead
    crossbar (output gain 0), and the core is marked dead, so the health
    monitor drains it onto peers (`AimcProgram.remap_context`) and
    reprograms there.
  * ``corrupt`` — the core's tiles lose a fraction of their conductance
    (gain 1 - magnitude): caught by the probe when the magnitude clears
    the threshold, repaired in place.

CLI form (``launch.serve --chaos``): comma-separated ``kill:CORE@CHUNK`` /
``corrupt:CORE@CHUNK[:MAGNITUDE]``, e.g. ``corrupt:0@2:0.5,kill:1@6``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.aimc import AimcLinearState
from repro_torch.core.program import AimcProgram

KILL = "kill"
CORRUPT = "corrupt"


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault, scheduled on the engine's chunk-dispatch index."""

    at_chunk: int
    kind: str                 # KILL | CORRUPT
    core: int
    magnitude: float = 1.0    # conductance fraction lost (1.0 = dead)

    def __post_init__(self):
        if self.kind not in (KILL, CORRUPT):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not 0.0 < self.magnitude <= 1.0:
            raise ValueError(f"magnitude must be in (0, 1], "
                             f"got {self.magnitude}")

    def describe(self) -> str:
        if self.kind == KILL:
            return f"kill core {self.core} @ chunk {self.at_chunk}"
        return (f"corrupt core {self.core} @ chunk {self.at_chunk} "
                f"(magnitude {self.magnitude:g})")


class FaultInjector:
    """Fires scheduled `FaultEvent`s as the engine's chunk counter passes
    them, once each; `fired` is the audit trail the serve report shows."""

    def __init__(self, events):
        self.events = tuple(sorted(events, key=lambda e: e.at_chunk))
        self.fired: list[FaultEvent] = []
        self._idx = 0

    def due(self, chunk_idx: int) -> list[FaultEvent]:
        out = []
        while (self._idx < len(self.events)
               and self.events[self._idx].at_chunk <= chunk_idx):
            out.append(self.events[self._idx])
            self._idx += 1
        self.fired.extend(out)
        return out

    @property
    def exhausted(self) -> bool:
        return self._idx >= len(self.events)

    def __len__(self) -> int:
        return len(self.events)


def corrupt_entries(program: AimcProgram, core: int,
                    magnitude: float) -> dict[str, AimcLinearState]:
    """Degraded views of every matrix on ``core``: output scales times
    ``1 - magnitude`` (0 = a dead crossbar, which reaches the kernel as an
    all-zero scale). Deterministic and shape-preserving, so it installs by
    `install_updates`."""
    gain = 1.0 - magnitude
    return {n: st.with_gain(gain)
            for n, st, c in zip(program.names, program.states,
                                program.contexts) if c == core}


def parse_chaos(spec: str) -> FaultInjector:
    """``kill:CORE@CHUNK`` / ``corrupt:CORE@CHUNK[:MAG]``, comma-joined."""
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, rest = part.split(":", 1)
            if kind == CORRUPT and rest.count(":") == 1:
                rest, mag = rest.rsplit(":", 1)
                magnitude = float(mag)
            else:
                magnitude = 1.0
            core, chunk = rest.split("@")
            events.append(FaultEvent(at_chunk=int(chunk), kind=kind,
                                     core=int(core), magnitude=magnitude))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad --chaos event {part!r} (want kill:CORE@CHUNK or "
                f"corrupt:CORE@CHUNK[:MAG]): {e}") from None
    if not events:
        raise ValueError(f"--chaos spec {spec!r} contains no events")
    return FaultInjector(events)
