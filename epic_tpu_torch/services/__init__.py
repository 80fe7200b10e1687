from . import messages
from .nav_core import EpicNavCorePlugin
from .navigation_node import EpicNavigationNode, EpicNavigationNodeRviz

__all__ = [
    "messages",
    "EpicNavCorePlugin",
    "EpicNavigationNode",
    "EpicNavigationNodeRviz",
]
