"""Mean number of requests in a group the MicroBatcher dispatched
during the window (`MicroBatcher.batch_sizes`)."""


def read(run):
    g = run.window.get("groups")
    return sum(g) / len(g) if g else None
