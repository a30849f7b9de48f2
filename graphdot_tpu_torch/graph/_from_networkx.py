"""NetworkX graph importer (fills the role of the reference's
``graphdot/graph/_from_networkx.py:7``)."""
import networkx as nx

from .frame import DataFrame


def _collect_attrs(items, what):
    """Verify attribute-name homogeneity across nodes/edges and return the
    sorted attribute names."""
    keys = None
    for ident, attrs in items:
        names = sorted(attrs.keys())
        if keys is None:
            keys = names
        elif names != keys:
            raise TypeError(
                f'{what} {ident} attributes {list(attrs.keys())} '
                f'inconsistent with {keys}'
            )
    return keys or []


def _from_networkx(cls, graph, weight=None):
    """Convert an undirected NetworkX graph with homogeneous node/edge
    attributes into a Graph.

    Parameters
    ----------
    graph: networkx.Graph
    weight: str or None
        Name of the edge attribute holding edge weights ('!w').
    """
    labels = list(graph.nodes)
    contiguous = (
        all(isinstance(x, int) for x in labels)
        and labels
        and min(labels) == 0
        and max(labels) == len(labels) - 1
    )
    if not contiguous:
        graph = nx.relabel.convert_node_labels_to_integers(graph)

    title = graph.graph.get('title', '')

    node_attr = _collect_attrs(graph.nodes.items(), 'Node')
    nodes = DataFrame({'!i': range(graph.number_of_nodes())})
    for key in node_attr:
        nodes[key] = [attrs[key] for attrs in graph.nodes.values()]

    if graph.number_of_edges() == 0:
        raise RuntimeError(f'Graph {graph} has no edges.')
    edge_attr = _collect_attrs(graph.edges.items(), 'Edge')
    edges = DataFrame()
    endpoints = list(graph.edges.keys())
    edges['!i'] = [i for i, _ in endpoints]
    edges['!j'] = [j for _, j in endpoints]
    if weight is not None:
        if weight not in edge_attr:
            raise KeyError(
                f'Weight attribute {weight!r} absent from edges.'
            )
        edges['!w'] = [
            attrs[weight] for attrs in graph.edges.values()
        ]
    for key in edge_attr:
        if key == weight:
            continue
        edges[key] = [attrs[key] for attrs in graph.edges.values()]

    return cls(nodes=nodes, edges=edges, title=title)
