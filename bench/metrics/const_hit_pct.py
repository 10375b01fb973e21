"""Share of the window's `engine.const` spans whose lookup the const
cache answered (its loader did not run), in %. Read from the engine's
spans (bench/spans.py); None without them."""


def read(rec):
    n = rec.get("span_count", {}).get("engine.const")
    if not n:
        return None
    return 100.0 * rec["span_hits"].get("engine.const", 0) / n
