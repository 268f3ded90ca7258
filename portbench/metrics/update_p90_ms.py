"""The 90th percentile of the times of all updates in the window, each
from the obstacle's move to a synchronise after ``update`` returns. Host
clock, milliseconds."""
from portbench.harness import stats


def read(ctx):
    if not ctx.counts.get('updates'):
        return None
    return stats.percentile(ctx.window.times, 90) * 1e3
