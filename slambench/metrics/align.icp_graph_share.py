"""align.icp_graph_share: the share of the program's align.icp spans after the
slice that replayed a captured CUDA graph (their ``graph`` attribute reads
"replay"; "capture" or "eager" otherwise), in %.  None where no align.icp span
carries the attribute (a program older than the graph)."""
from slambench.lib.program_spans import steady_records


def read(run):
    recs = steady_records(run)
    if recs is None:
        return None
    icp = [r for r in recs if r.name == "align.icp"]
    if not any("graph" in r.attrs for r in icp):
        return None
    return 100.0 * sum(r.attrs.get("graph") == "replay" for r in icp) / len(icp)
