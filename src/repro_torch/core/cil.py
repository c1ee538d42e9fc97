"""Container Information List (paper Sec. V-A).

The CIL is the Predictor's *client-side shadow* of which containers are warm in
the provider's infrastructure. AWS exposes no API for this, so the framework
maintains its own estimate, updated after every placement decision:

- per configuration λ_m, a list of containers with (busy|idle) status, the
  completion time of the latest function executed in the container, and the
  estimated destruction time (completion + T_idl);
- a dispatch to a configuration with an idle container is predicted WARM (the
  idle container with the most recent completion time is assumed to be reused,
  matching the paper's empirical observation of AWS Lambda);
- otherwise the dispatch is predicted COLD and a new container record is added;
- dead containers (idle past their estimated lifetime) are reaped on every
  update.

All times are in milliseconds. In the TPU-fleet adaptation the same structure
tracks which slice executors hold a resident compiled executable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# The paper measures T_idl ≈ 27 minutes via binary search (corroborating [32]).
DEFAULT_T_IDL_MS = 27.0 * 60.0 * 1000.0


@dataclass
class ContainerRecord:
    config: str
    busy_until: float  # completion time of the latest function (ms)
    last_completion: float  # == busy_until after completion

    def is_busy(self, now: float) -> bool:
        return now < self.busy_until

    def expires_at(self, t_idl_ms: float) -> float:
        return self.last_completion + t_idl_ms


@dataclass
class ContainerInfoList:
    t_idl_ms: float = DEFAULT_T_IDL_MS
    containers: dict[str, list[ContainerRecord]] = field(default_factory=dict)

    # ------------------------------------------------------------------ query
    def reap(self, now: float) -> int:
        """Remove containers idle past their estimated lifetime. Returns #reaped."""
        reaped = 0
        for cfg, lst in self.containers.items():
            keep = [
                c for c in lst
                if c.is_busy(now) or now <= c.expires_at(self.t_idl_ms)
            ]
            reaped += len(lst) - len(keep)
            self.containers[cfg] = keep
        return reaped

    def idle_containers(self, config: str, now: float) -> list[ContainerRecord]:
        """Idle, unexpired containers, most-recent-completion first (reuse order)."""
        lst = [
            c for c in self.containers.get(config, [])
            if not c.is_busy(now) and now <= c.expires_at(self.t_idl_ms)
        ]
        return sorted(lst, key=lambda c: -c.last_completion)

    def will_warm_start(self, config: str, now: float) -> bool:
        return len(self.idle_containers(config, now)) > 0

    def count(self, config: str) -> int:
        return len(self.containers.get(config, []))

    # ----------------------------------------------------------------- update
    def record_dispatch(self, config: str, now: float, completion_time: float) -> bool:
        """Record a dispatch decided at ``now`` whose function is estimated to
        complete (container released) at ``completion_time``.

        Returns True if this dispatch is a (predicted) cold start.
        """
        self.reap(now)
        idle = self.idle_containers(config, now)
        if idle:
            c = idle[0]  # most recent completion — the paper's reuse assumption
            c.busy_until = completion_time
            c.last_completion = completion_time
            return False
        rec = ContainerRecord(config=config, busy_until=completion_time,
                              last_completion=completion_time)
        self.containers.setdefault(config, []).append(rec)
        return True

    def prewarm(self, config: str, ready_ms: float,
                keepalive_until_ms: float) -> ContainerRecord:
        """Add a speculatively spawned container, warm for exactly
        ``[ready_ms, keepalive_until_ms]``.

        Both the walk path (``idle_containers`` → ``expires_at``) and the
        columnar decision core hardcode the warm window as
        ``busy_until <= now <= last_completion + t_idl``, so the record
        encodes the keep-alive horizon through ``last_completion =
        keepalive_until_ms - t_idl_ms`` rather than a new field — a
        prewarmed container needs zero changes in either consumer. The
        shifted ``last_completion`` also makes prewarmed records the
        *least*-recently-completed idle containers, so genuinely warm
        containers win the MRU reuse race and the prewarmed pool absorbs
        overflow only. Reuse via ``record_dispatch`` converts the record to
        the normal completion-driven lifecycle.
        """
        if not keepalive_until_ms > ready_ms:
            raise ValueError(
                f"prewarm keep-alive window must end after it starts: "
                f"keepalive_until_ms={keepalive_until_ms!r} <= "
                f"ready_ms={ready_ms!r}")
        rec = ContainerRecord(
            config=config, busy_until=float(ready_ms),
            last_completion=float(keepalive_until_ms) - self.t_idl_ms)
        self.containers.setdefault(config, []).append(rec)
        return rec
