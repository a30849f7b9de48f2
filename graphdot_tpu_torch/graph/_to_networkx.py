"""Graph -> NetworkX export (fills the role of the reference's
``graphdot/graph/_to_networkx.py``), built column-wise with no pandas
round trip."""
import networkx as nx


def _column_records(frame, keys):
    """Per-row attribute dicts of a frame, excluding the index keys."""
    payload = {c: list(frame[c]) for c in frame.columns if c not in keys}
    count = len(frame)
    return [
        {name: values[r] for name, values in payload.items()}
        for r in range(count)
    ]


def _to_networkx(graph):
    """Rebuild a ``networkx.Graph`` carrying all node and edge
    attributes of this Graph."""
    out = nx.Graph(title=graph.title)
    out.add_nodes_from(zip(
        list(graph.nodes['!i']),
        _column_records(graph.nodes, ('!i',)),
    ))
    out.add_edges_from(zip(
        list(graph.edges['!i']),
        list(graph.edges['!j']),
        _column_records(graph.edges, ('!i', '!j')),
    ))
    return out
