"""ADMM iterations per route: the mean of ``Route.iters`` over the traced
routes, which the program counts as the base solve's iterations plus the
refinement's."""


def read(run):
    its = [r["answer"]["iters"] for r in run.requests if r.get("answer")]
    return sum(its) / len(its) if its else None
