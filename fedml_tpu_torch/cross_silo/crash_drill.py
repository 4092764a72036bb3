"""Crash drills of the plain synchronous protocol in one process (the port's
counterpart of the reference's ``cross_silo/async_soak.py`` crash-parity
harnesses, for the sync server).

:func:`run_with_crashes` runs a server and its clients (in-process or TCP)
and injects, at the server's sends, up to two crashes:

- ``kill_server_before_round=R``: at the server's first dispatch of round
  ``R`` (after round ``R - 1``'s journal snapshot) the server is
  hard-killed and what it would still send is lost; a new server is built
  over the same journal, recovers, and runs the rest under the next session
  epoch;
- ``kill_client=(rank, R)``: just before round ``R``'s dispatch reaches
  ``rank``, that client is hard-killed, a replacement is built over the same
  client journal (it resumes from it), and the dispatch goes to the
  replacement.

Both need the journals (``extra.server_journal_dir``,
``extra.client_journal_dir``).  The crashes are placed by the protocol's
own messages, not by timing, so a drill reproduces.  Returns the final
server (whose aggregator holds the final global), the clients and what
happened.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from .. import constants as C
from ..comm.tcp_backend import link_ports
from . import build_client, build_process_group, build_server
from . import message_define as md

log = logging.getLogger("fedml_tpu_torch.cross_silo.crash_drill")

_DISPATCH = (md.MSG_TYPE_S2C_INIT_CONFIG, md.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)


def run_with_crashes(cfg, dataset, model, device, *, backend: str = C.COMM_BACKEND_INPROC,
                     kill_server_before_round: Optional[int] = None,
                     kill_client: Optional[tuple] = None, timeout: float = 600.0,
                     global_vars=None, perms=None, logger=None, trust_sampler=None) -> dict:
    """Run ``cfg``'s plain cross-silo group with the crashes asked for;
    returns ``{"server", "clients", "history", "server_kills", "client_kills",
    "first_server"}`` (``history``: the rounds of every server life)."""
    hooks = dict(global_vars=global_vars, logger=logger, trust_sampler=trust_sampler)
    server, clients = build_process_group(cfg, dataset, model, device, backend=backend,
                                          perms=perms, **hooks)
    state = {"server_kills": 0, "client_kills": 0, "first_server": server}
    threads = {}
    killed = threading.Event()

    def start_client(c):
        c.on_error = lambda reason, error=None: state["server"].abort(reason, error)
        threads[c.rank] = c.run_in_thread()

    def tap(srv):
        send = srv.send_message

        def send_tapped(msg):
            if srv is state["first_server"] and killed.is_set():
                return  # a dead server sends nothing
            rnd = msg.get_control(md.MSG_ARG_KEY_ROUND_INDEX)
            if msg.get_type() in _DISPATCH and rnd is not None:
                if (srv is state["first_server"] and kill_server_before_round is not None
                        and int(rnd) == kill_server_before_round):
                    state["server_kills"] += 1
                    killed.set()
                    srv.hard_kill()
                    return
                rank = int(msg.get_receiver_id())
                if (kill_client is not None and state["client_kills"] == 0
                        and (rank, int(rnd)) == tuple(kill_client)):
                    _swap_client(rank)
            send(msg)

        srv.send_message = send_tapped

    def _swap_client(rank):
        old = clients[rank - 1]
        old.hard_kill()
        # the dead loop must be gone before the dispatch lands, or it could
        # take the dispatch and drop it
        threads[rank].join(timeout=5.0)
        if threads[rank].is_alive():
            raise RuntimeError(f"crash drill: client {rank}'s receive loop did not stop")
        new = build_client(cfg, dataset, model, rank, device, backend=backend, perms=perms)
        clients[rank - 1] = new
        link_ports([state["server"], *clients])
        start_client(new)
        state["client_kills"] += 1
        log.info("crash drill: client %d killed and resumed (from its journal: %s)", rank,
                 new.resumed_from_journal)

    state["server"] = server
    tap(server)
    for c in clients:
        start_client(c)
    history = []
    try:
        if kill_server_before_round is not None:
            thread = server.run_in_thread()
            server.start()
            deadline = time.monotonic() + timeout
            while not (killed.wait(0.05) or server.done.is_set()):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"crash drill: no kill and no finish in {timeout}s "
                                       f"(round {server.round_idx})")
            if server.failed:
                raise RuntimeError(f"cross-silo run failed: {server.failed}")
            thread.join(timeout=5.0)
            history += server.history
            if killed.is_set():
                server = build_server(cfg, dataset, model, device, backend=backend, **hooks)
                state["server"] = server
                link_ports([server, *clients])
                tap(server)
        if not server.done.is_set():
            history += server.run_until_done(timeout=timeout)
        for c in clients:
            c.done.wait(5.0)
    finally:
        for c in clients:
            c.finish()
        state["first_server"].finish()
    return {"server": server, "clients": clients, "history": history, **state}
