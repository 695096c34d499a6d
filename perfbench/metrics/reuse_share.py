"""reuse_share: prompt tokens served from cached prefixes over all prompt
tokens the engine admitted in the window, from its counters
(reused_tokens / (reused_tokens + prefilled_tokens)), in %."""


def read(run):
    a, b = run.counters.get("open"), run.counters.get("close")
    if not a or not b:
        return None
    reused = b["reused_tokens"] - a["reused_tokens"]
    prefilled = b["prefilled_tokens"] - a["prefilled_tokens"]
    if reused + prefilled <= 0:
        return None
    return 100.0 * reused / (reused + prefilled)
