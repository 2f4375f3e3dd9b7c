"""Serve CLI: ``python -m repro_torch.serve`` starts the session server.

Modes::

    PYTHONPATH=src python -m repro_torch.serve --port 8642
        Serve on the card until interrupted (SIGINT) or POST /shutdown.

    PYTHONPATH=src python -m repro_torch.serve --smoke examples/scenarios/x.json
        The lifecycle check: bind an ephemeral port, create a session from
        the scenario, stream two chunks over HTTP, suspend, resume, run
        again, and check that a second session of the scenario captures
        and builds nothing; shut down.  Exit 0 on success; any failed
        check raises (a non-zero exit, with the message).

Both run on the card, and raise without one, unless ``--device cpu``
asks for the kernels' plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"smoke: {msg}")


def _smoke(scenario: str, warm_ms: float | None, device) -> int:
    from repro_torch.serve.http import ServeClient, SimServer
    from repro_torch.serve.session import SessionManager

    server = SimServer(SessionManager(warm_ms=warm_ms, device=device),
                       port=0).start()
    print(f"smoke: serving on {server.url} ({server.manager.device})",
          flush=True)
    try:
        client = ServeClient(server.url, timeout=600.0)
        _check(client.healthz().get("ok") is True, "healthz failed")

        sid = client.create(scenario_path=scenario)["id"]
        print(f"smoke: created session {sid}", flush=True)

        records = client.run(sid, t_ms=100.0, chunk_ms=50.0)
        chunks = [r for r in records if "chunk" in r]
        final = records[-1]
        _check(len(chunks) == 2, f"expected 2 streamed chunks, got "
                                 f"{records}")
        _check(bool(final.get("done")), f"missing final summary: {records}")
        print(f"smoke: streamed {len(chunks)} chunks, "
              f"rtf={final['rtf']:.3f}", flush=True)

        ckpt = client.suspend(sid)["checkpoint"]
        info = next(s for s in client.sessions() if s["id"] == sid)
        _check(info["status"] == "suspended", f"not suspended: {info}")
        print(f"smoke: suspended -> {ckpt}", flush=True)

        client.resume(sid)
        records = client.run(sid, t_ms=50.0)
        _check(bool(records[-1].get("done")), f"run after resume: "
                                              f"{records}")
        print("smoke: resumed and ran again", flush=True)

        # a second session of the scenario captures and builds nothing
        stats0 = client.stats()
        sid2 = client.create(scenario_path=scenario)["id"]
        client.run(sid2, t_ms=50.0)
        stats1 = client.stats()
        before = stats0["compile_caches"]["compiles"]
        after = stats1["compile_caches"]["compiles"]
        _check(after == before, f"the second same-scenario session "
                                f"captured or built: {before} -> {after}")
        print(f"smoke: second session shared all {after} captures and "
              f"builds", flush=True)

        client.destroy(sid)
        client.destroy(sid2)
        client.shutdown()
        print("smoke: ok", flush=True)
        return 0
    finally:
        server.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch session server (stdlib HTTP/JSON front "
                    "end)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642,
                    help="0 binds an ephemeral port")
    ap.add_argument("--root", default=None,
                    help="checkpoint root for suspended sessions "
                         "(default: a temporary directory)")
    ap.add_argument("--max-backends", type=int, default=8)
    ap.add_argument("--warm-ms", type=float, default=None,
                    help="capture each new session's graphs for this "
                         "horizon at create time")
    ap.add_argument("--smoke", metavar="SCENARIO", default=None,
                    help="run the lifecycle check against this scenario "
                         "JSON and exit")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain PyTorch versions on "
                         "the CPU; the default is the CUDA card, and no "
                         "card is an error")
    args = ap.parse_args(argv)

    from repro_torch.api.simulator import session_device
    device = session_device(args.device)
    if args.smoke is not None:
        return _smoke(args.smoke, args.warm_ms, device)

    from repro_torch.serve.http import SimServer
    from repro_torch.serve.session import SessionManager

    manager = SessionManager(root=args.root,
                             max_backends=args.max_backends,
                             warm_ms=args.warm_ms, device=device)
    server = SimServer(manager, host=args.host, port=args.port,
                       quiet=False)
    print(f"serving on {server.url} ({device}; POST /shutdown or Ctrl-C "
          f"to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
