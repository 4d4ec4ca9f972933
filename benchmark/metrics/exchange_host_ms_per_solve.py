"""exchange_host_ms_per_solve: the summed duration of the port's
st.exchange and st.exchange_df spans per traced solve, in ms of the host's
clock: the duplicate-site exchanges' dispatch (V-cycle and exchange
dispatch layer; benchmark.spans).  Traced, so the profiler's cost is in it."""
from benchmark import spans


def read(run):
    return spans.ms_per_solve(run, ("st.exchange", "st.exchange_df"))
