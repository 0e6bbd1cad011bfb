"""Host ms per request of the estm_stream protocol, from the call that
issues it to its return, before the fetch waits (the first half of a
traced run)."""

from portbench.harness.readings import host_issue_ms


def read(r):
    return host_issue_ms(r, "estm_stream")
