"""Host milliseconds the decision engine spends per task placed: the
harness's span around ``DecisionEngine.place_many`` (wrapped on the engine
instance), summed over the window, over the tasks it placed there."""


def read(ctx):
    seconds, tasks = ctx["place"]
    return seconds * 1e3 / tasks if tasks else None
