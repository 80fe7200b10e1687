from . import messages
from .navigation_node import EpicNavigationNode, EpicNavigationNodeRviz

__all__ = [
    "messages",
    "EpicNavigationNode",
    "EpicNavigationNodeRviz",
]
