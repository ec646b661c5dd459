"""Out-of-process host-tail execution for the serving streams.

The k-edit filter engine's host tail (cluster state machine + batched
native verify, ``models.primer_match._filter_emit``) is GIL-held Python.
Run on a worker THREAD it strangles the device dispatch loop — CPython's
GIL serializes the two.  A worker PROCESS owns its own GIL, so the tail
truly overlaps the main process's dispatch: the stream ships the
candidate arrays over a pipe and receives the emitted hit arrays back.

The child rebuilds the model from primitives (codes, table, entry
layout, patterns, flags) on the CPU platform (mesh=None, host-only code
paths), so spawning it never opens the card: a second JAX process on a
GPU would reserve its own share of the card's memory.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np


def _tail_worker(conn, spec):
    """Child main: rebuild the model, serve _filter_emit requests."""
    try:
        # never touch the device from the tail child: pin the platform
        # before any backend use (the env var covers a fresh import, the
        # config update an interpreter that imported jax already)
        os.environ["JAX_PLATFORMS"] = "cpu"
        # a child is one lane of a round-robin pair on a small host:
        # keep its native verify pool single-threaded
        os.environ.setdefault("SAT_VERIFY_THREADS", "1")
        try:
            import jax

            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
        import numpy as np

        from ..io.database import SeqDB
        from ..io.patterns import PatternSet
        from ..models.primer_match import PrimerMatchModel

        db = SeqDB(
            codes=np.frombuffer(spec["codes"], dtype=np.uint8),
            table=spec["table"],
            entry_starts=spec["entry_starts"],
            entry_lengths=spec["entry_lengths"],
            headers=spec["headers"],
        )
        ps = PatternSet()
        ps.patterns = spec["patterns"]
        ps.esb = spec["esb"]
        ps.eeb = spec["eeb"]
        ps.n_forward = spec["n_forward"]
        model = PrimerMatchModel(
            db, ps, k=spec["k"], indels=spec["indels"], wc=spec["wc"],
            textn=spec["textn"], dna_mut=spec["dna_mut"],
            report_interval=spec["report_interval"], mesh=None)
        if model.engine != "filter":
            from ..engine.verify import EditDistAligner

            model._cluster_aligner = EditDistAligner(
                spec["k"], chr(db.eos_char), spec["wc"], spec["textn"],
                spec["indels"], spec["dna_mut"], yesno=True)
            model.engine = "filter"
        conn.send("ready")
        while True:
            msg = conn.recv()
            if msg is None:
                break
            sends, spids = msg
            rounds = list(model._filter_emit_rounds(sends, spids))
            z = np.zeros(0, np.int64)
            conn.send((
                np.concatenate([r[0] for r in rounds]) if rounds else z,
                np.concatenate([r[1] for r in rounds]) if rounds else z,
                np.concatenate([r[2] for r in rounds]) if rounds else z,
            ))
    except (EOFError, KeyboardInterrupt):
        pass
    except Exception as e:  # surface build/protocol errors to the parent
        try:
            conn.send(("error", repr(e)))
        except Exception:
            pass


class FilterTailProcess:
    """Persistent out-of-process _filter_emit executor.

    ``submit(sends, spids)`` ships one rep's candidates; ``result()``
    blocks for the oldest outstanding rep and returns its hit list.  At
    most one rep is in flight in the child at a time (the protocol is
    FIFO over one pipe); the caller keeps its own pending queue.
    """

    def __init__(self, model):
        ps, db = model.ps, model.db
        spec = {
            "codes": np.ascontiguousarray(
                np.asarray(db.codes, np.uint8)).tobytes(),
            "table": db.table,
            "entry_starts": np.asarray(db.entry_starts),
            "entry_lengths": np.asarray(db.entry_lengths),
            "headers": list(db.headers),
            "patterns": list(ps.patterns),
            "esb": list(ps.esb),
            "eeb": list(ps.eeb),
            "n_forward": ps.n_forward,
            "k": model.k, "indels": model.indels, "wc": model.wc,
            "textn": model.textn, "dna_mut": model.dna_mut,
            "report_interval": model.report_interval,
        }
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_tail_worker, args=(child, spec), daemon=True)
        self._proc.start()
        child.close()
        msg = self._conn.recv()
        if msg != "ready":
            raise RuntimeError(f"tail worker failed: {msg}")

    def submit(self, sends, spids):
        self._conn.send((sends, spids))

    def result(self):
        msg = self._conn.recv()
        if isinstance(msg, tuple) and len(msg) == 2 and msg[0] == "error":
            raise RuntimeError(f"tail worker failed: {msg[1]}")
        ends, pids, vals = msg
        return list(zip(ends.tolist(), pids.tolist(), vals.tolist()))

    def close(self):
        try:
            self._conn.send(None)
            self._proc.join(timeout=5)
        except Exception:
            pass
        finally:
            try:
                self._conn.close()
            except Exception:
                pass
            if self._proc.is_alive():
                self._proc.terminate()


class FilterTailPool:
    """Round-robin pair of :class:`FilterTailProcess` lanes.

    One lane's service time (~tail + IPC) is close to the device period,
    so backpressure stalls the dispatch loop; two lanes halve each
    lane's arrival rate while submit/result stay strictly FIFO (results
    are drained in submission order, alternating lanes)."""

    def __init__(self, model, lanes: int = 3):
        self._lanes = [FilterTailProcess(model) for _ in range(lanes)]
        self._sub = 0
        self._res = 0

    def submit(self, sends, spids):
        self._lanes[self._sub % len(self._lanes)].submit(sends, spids)
        self._sub += 1

    def result(self):
        out = self._lanes[self._res % len(self._lanes)].result()
        self._res += 1
        return out

    def close(self):
        for lane in self._lanes:
            lane.close()
