"""Open loop: the churn of a running cluster (``workload.churn``), driven
over gRPC by the client at the traffic file's rate."""

from portbench import drive, workload


def loop(ctx) -> dict:
    rate = ctx.rate if ctx.rate else float(ctx.traffic["rate"])
    plan = workload.churn(ctx.config, ctx.traffic, ctx.seed, ctx.seconds,
                          rate)
    return drive.run_plan(ctx, workload.machines(ctx.config, ctx.seed), plan)
