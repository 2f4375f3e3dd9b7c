"""Session-server walkthrough on the port: many users, one warm network.

The counterpart of ``examples/serve_sessions.py`` for ``repro_torch``:
each user holds a live microcircuit with its own state, while every
session of one scenario shares one built backend and one capture of each
graph set (``repro_torch.serve``).

Two modes::

    PYTHONPATH=src python examples/serve_sessions_torch.py [--device cpu]
        In-process: drives a SessionManager directly -- seeded replicas
        run as one coalesced group, one suspended to disk and resumed, the
        counted caches printed.

    PYTHONPATH=src python examples/serve_sessions_torch.py --http
        The same lifecycle over the stdlib HTTP/JSON front end (an
        ephemeral local SimServer and its ServeClient), streaming
        per-chunk snapshots.

Both run on the card, and raise without one, unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

SCENARIO = "examples/scenarios/smoke_background.json"


def in_process(scenario: str, device) -> None:
    from repro_torch.serve import SessionManager

    with SessionManager(device=device) as mgr:
        # three users, one scenario: seeded replicas share the backend,
        # so only the first create builds and the first run captures
        sessions = [mgr.create(scenario, seed=100 + i) for i in range(3)]
        ids = [s.id for s in sessions]
        print("sessions:", ids)

        # coalesced: one run_batch over the group's states, bitwise each
        # session's own run
        results = mgr.run_many({sid: 200.0 for sid in ids})
        for sid in ids:
            r = results[sid]
            spikes = int(r.data["pop_counts"].sum())
            print(f"  {sid}: {spikes} spikes, rtf={r.rtf:.3f}")

        # park one user: checkpoint to disk, release its state
        mgr.suspend(ids[0])
        print("suspended:", ids[0], "->", mgr.get(ids[0]).ckpt_dir)
        mgr.resume(ids[0])
        r = mgr.run(ids[0], 100.0)
        print("resumed:", ids[0], f"rtf={r.rtf:.3f}")

        stats = mgr.stats()
        print("backend pool:", stats["backend_pool"])
        print("captures and builds:", stats["compile_caches"]["compiles"])


def over_http(scenario: str, device) -> None:
    from repro_torch.serve import ServeClient, SessionManager, SimServer

    server = SimServer(SessionManager(device=device), port=0).start()
    print("serving on", server.url)
    try:
        client = ServeClient(server.url)
        ids = [client.create(scenario_path=scenario, seed=100 + i)["id"]
               for i in range(2)]
        print("sessions:", ids)

        # streamed run: one NDJSON record per 100 ms chunk
        for rec in client.run(ids[0], t_ms=300.0, chunk_ms=100.0):
            if "chunk" in rec:
                print(f"  chunk {rec['chunk']}: "
                      f"t={rec['t_model_ms']:.0f} ms rtf={rec['rtf']:.3f} "
                      f"pop_spikes={rec.get('pop_spikes')}")
            elif rec.get("done"):
                print(f"  done: session at "
                      f"{rec['session_t_model_ms']:.0f} ms model time")

        print("suspend/resume:", client.suspend(ids[0])["checkpoint"])
        client.resume(ids[0])
        client.run_many({sid: 100.0 for sid in ids})
        print("stats:", client.stats()["compile_caches"]["totals"])
        client.shutdown()
    finally:
        server.stop()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default=SCENARIO)
    ap.add_argument("--http", action="store_true",
                    help="run the lifecycle over the HTTP front end")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU; the default is the CUDA card")
    args = ap.parse_args()
    if args.http:
        over_http(args.scenario, args.device)
    else:
        in_process(args.scenario, args.device)


if __name__ == "__main__":
    main()
