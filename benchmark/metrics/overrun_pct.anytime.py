"""The share of the window's cycles whose poses came back more than one
update period after the cycle was due (host clock): the node's missed
deadlines. A walk that runs to upstream's point budget (seconds on the maze)
makes the cycles queued behind it late too."""


def read(run):
    if not run.items:
        return None
    period = 1.0 / run.config["update_rate_hz"]
    late = sum(1 for i in run.items if i["end"] - i["start"] > period)
    return 100.0 * late / len(run.items)
