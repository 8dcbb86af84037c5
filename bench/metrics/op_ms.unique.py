"""Mean host-clock time of one `unique` call over the traced window, from the
benchmark's own span around it (ending in a wait for the card)."""

from _reads import span_ms


def read(obs):
    return span_ms(obs, "unique")
