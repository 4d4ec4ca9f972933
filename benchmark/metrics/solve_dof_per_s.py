"""solve_dof_per_s: the configuration's DoF times the solves the window
completed correctly, over the window's seconds (the end of the last
request included): bench.py's DoF/s, over all the work of the window."""


def read(run):
    done = sum(1 for r in run.requests if r["ok"])
    if not run.requests or run.window_s <= 0:
        return None
    return run.config["expect"]["dofs"] * done / run.window_s
