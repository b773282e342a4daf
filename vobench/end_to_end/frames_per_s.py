"""Frames whose pose reached the host inside the window, over the
window's seconds: all the work over all the time."""


def read(window):
    return window.completed / window.seconds
