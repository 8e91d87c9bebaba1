"""Seconds from the process's start to the window's start: data, server
open, import, kernel build and load, residency and warm-up."""


def read(rec):
    return rec["setup_s"]
