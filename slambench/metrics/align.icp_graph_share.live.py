"""align.icp_graph_share.live: the share of align.icp spans that replayed a
captured CUDA graph, in % (live)."""
from slambench.lib.spec import metric_reader

read = metric_reader("align.icp_graph_share")
