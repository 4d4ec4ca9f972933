"""assembly_s: seconds of xupdate_solve.assemble in set-up, on the
benchmark's clock, synchronized (entry layer; moves setup_s)."""


def read(run):
    return run.setup_parts.get("assembly_s")
