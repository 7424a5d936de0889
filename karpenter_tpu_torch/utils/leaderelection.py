"""Leader election over a lease file.

The reference deploys replicas with controller-runtime leader election
(chart ``deployment.yaml``; operator flag table): only the leader runs the
reconcile loops and background refreshers. Without an apiserver, the lease
is a file — acquired under an ``fcntl.flock`` on a sidecar lock file (so the
read-check-write sequence is atomic among contenders), carried with a holder
identity + deadline, renewed on a heartbeat, stealable once expired. Same
semantics as a coordination.k8s.io Lease: at most one live holder, takeover
on expiry.

Mutual exclusion holds only among processes that see the SAME lease file:
multi-replica deployments must point ``--leader-elect-lease`` at a shared
(ReadWriteMany) volume. The shipped manifest defaults to 1 replica because
a pod-local path cannot coordinate across pods (see deploy/render.py).
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
import uuid
from typing import Optional


class LeaderElector:
    def __init__(
        self,
        lease_path: str,
        identity: Optional[str] = None,
        lease_duration: float = 15.0,
        renew_interval: float = 5.0,
        on_lost: Optional[callable] = None,
    ):
        self.lease_path = lease_path
        self.identity = identity or f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval
        # invoked (once) from the renewal thread if leadership is lost — the
        # caller must stop reconciling: a deposed leader running alongside the
        # new one is split-brain (controller-runtime exits the process here)
        self.on_lost = on_lost
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = False

    # -- lease file ops ------------------------------------------------------
    def _read(self) -> Optional[dict]:
        try:
            with open(self.lease_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self) -> None:
        tmp = f"{self.lease_path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"holder": self.identity, "renewed": time.time(),
                 "duration": self.lease_duration},
                f,
            )
        os.replace(tmp, self.lease_path)  # atomic on POSIX

    def try_acquire(self) -> bool:
        """One acquisition attempt: take a free/expired lease, renew our own.

        The whole read-check-write runs under an exclusive flock on a sidecar
        lock file, so two contenders cannot both pass the expiry check and
        both write. The flock is blocking: the critical section is a few file
        ops, and a non-blocking miss here would make the renewal heartbeat
        treat transient contention as a lost lease.
        """
        with open(f"{self.lease_path}.lock", "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                lease = self._read()
                now = time.time()
                if lease is not None and lease.get("holder") != self.identity:
                    expired = (
                        now - lease.get("renewed", 0)
                        > lease.get("duration", self.lease_duration)
                    )
                    if not expired:
                        self.is_leader = False
                        return False
                self._write()
                self.is_leader = True
                return True
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def acquire(self, stop: Optional[threading.Event] = None, poll: float = 1.0) -> bool:
        """Block until leadership (or ``stop``); then renew on a heartbeat."""
        while not (stop and stop.is_set()):
            if self.try_acquire():
                self._start_renewal()
                return True
            time.sleep(poll)
        return False

    def _start_renewal(self) -> None:
        self._stop.clear()

        def renew() -> None:
            while not self._stop.wait(self.renew_interval):
                if not self.try_acquire():
                    self.is_leader = False  # lost the lease (stolen post-expiry)
                    if self.on_lost is not None:
                        self.on_lost()
                    return

        self._thread = threading.Thread(target=renew, daemon=True)
        self._thread.start()

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.is_leader:
            # same critical section as try_acquire: between an unguarded read
            # and unlink a successor could write a fresh lease we'd then delete
            with open(f"{self.lease_path}.lock", "a") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    lease = self._read()
                    if lease and lease.get("holder") == self.identity:
                        try:
                            os.unlink(self.lease_path)
                        except FileNotFoundError:
                            pass
                finally:
                    fcntl.flock(lockf, fcntl.LOCK_UN)
        self.is_leader = False
