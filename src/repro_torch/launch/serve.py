"""Workflow-serving launcher: realizes a Scepsy deployment on H100 hosts.

Given a workflow + cluster + target rate it runs the full Scepsy flow
(trace -> profile -> schedule -> place), writes the deployment manifest
(the Kubernetes-file analogue; placement decisions are locked ahead of
time per §6), then serves an open-loop request stream through the
simulated cluster and reports the achieved throughput-latency point.
``--gpus N`` builds hosts of 8 H100 GPUs, each host one 8-GPU NVLink
domain, with a partial last host when N is not a multiple of 8.

It runs on the host, not on a card: the planner and the simulated
cluster are host code, priced by the cost model's ``h100`` class.

  PYTHONPATH=src python -m repro_torch.launch.serve --workflow beam_search \
      --gpus 8 --rate 0.4 --requests 60
"""
from __future__ import annotations

import argparse

from repro_torch import hw
from repro_torch.core.scepsy import deploy
from repro_torch.core.placement import save_deployment
from repro_torch.serving.deploy import routers_from_allocations
from repro_torch.serving.simulator import EventLoop
from repro_torch.workflows.beam_search import BEAM_SEARCH
from repro_torch.workflows.rag_reranker import RAG_RERANKER
from repro_torch.workflows.runtime import ClusterDriver

WORKFLOWS = {w.name: w for w in (BEAM_SEARCH, RAG_RERANKER)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workflow", default="beam_search",
                    choices=sorted(WORKFLOWS))
    ap.add_argument("--gpus", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.4)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    wf = WORKFLOWS[args.workflow]
    if args.gpus < 1:
        ap.error("--gpus must be at least 1")
    spec = hw.ClusterSpec(num_hosts=args.gpus // 8, chips_per_host=8,
                          hb_domain_size=8, tail_chips=args.gpus % 8)
    print(f"== Scepsy deploy: {wf.name} on {spec.num_chips} "
          f"{hw.DEFAULT_CHIP_CLASS.name} GPUs, "
          f"target {args.rate} req/s")
    dep = deploy(wf, spec, args.rate, n_trace_requests=30, seed=args.seed)
    for m, a in dep.schedule.allocations.items():
        print(f"  {m}: replicas={a.replicas} tp={a.tp} "
              f"fraction={a.fraction:.2f}")
    print(f"  predicted: latency={dep.schedule.prediction.latency:.2f}s "
          f"max_tput={dep.schedule.prediction.max_throughput:.3f} req/s")
    if args.manifest:
        save_deployment(dep.placement, args.manifest)
        print(f"  manifest -> {args.manifest}")

    loop = EventLoop()
    routers = routers_from_allocations(wf, dep.schedule.allocations, loop)
    driver = ClusterDriver(wf, routers, loop)
    recs = driver.run_open_loop(args.rate, args.requests, seed=args.seed)
    lats = sorted(r.latency for r in recs)
    span = max(r.done for r in recs) - min(r.arrival for r in recs)
    print(f"== served {len(recs)} requests: "
          f"tput={len(recs)/span:.3f} req/s "
          f"mean={sum(lats)/len(lats):.2f}s p50={lats[len(lats)//2]:.2f}s "
          f"p99={lats[int(0.99*(len(lats)-1))]:.2f}s")


if __name__ == "__main__":
    main()
