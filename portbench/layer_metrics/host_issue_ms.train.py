"""Host ms per request of the train_step protocol, from the call that
issues it to its return, before the fetch waits (the first half of a
traced run)."""

from portbench.harness.readings import host_issue_ms


def read(r):
    return host_issue_ms(r, "train_step")
