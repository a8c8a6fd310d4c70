"""The harness's own arithmetic: a copy that program changes cannot move."""
