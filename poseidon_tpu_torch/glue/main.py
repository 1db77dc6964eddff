"""Poseidon glue process entry point.

The analog of the reference's ``cmd/poseidon/poseidon.go:90-103`` main:
parse config, connect to the scheduler service, gate on its health check,
then run the watcher/stats/schedule-loop families until signalled.

Runs against a real cluster when the ``kubernetes`` client package is
available (``--kube-config`` / in-cluster); ``--demo`` runs the in-process
fake cluster with a small synthetic workload instead (no dependencies),
which is also the integration-smoke path.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading

from poseidon_tpu_torch.utils.config import PoseidonConfig, load_config

log = logging.getLogger("poseidon.main")


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
    )
    demo = False
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--demo" in argv:
        demo = True
        argv.remove("--demo")
    cfg = load_config(PoseidonConfig, argv=argv)

    if demo:
        from poseidon_tpu_torch.glue.fake_kube import FakeKube, Node, Pod

        kube = FakeKube()
        for i in range(4):
            kube.add_node(
                Node(name=f"demo-n{i}", cpu_capacity=8000,
                     ram_capacity=16 << 20)
            )
        for i in range(12):
            kube.create_pod(
                Pod(name=f"demo-p{i}", cpu_request=250,
                    ram_request=1 << 19)
            )
    else:
        from poseidon_tpu_torch.glue.kube_client import RealKube

        kube = RealKube(kubeconfig=cfg.kube_config)

    from poseidon_tpu_torch.glue.poseidon import Poseidon

    poseidon = Poseidon(
        kube, config=cfg, stats_address=cfg.stats_server_address
    )
    poseidon.start()
    log.info(
        "poseidon running: firmament=%s stats=%s interval=%.1fs",
        cfg.firmament_address, cfg.stats_server_address,
        cfg.scheduling_interval,
    )

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    poseidon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
