"""Process start to the first timed frame: importing, rendering the
frames (and writing the png cell's files), building the kernels in a
fresh checkout, and warming the cell's shapes up."""


def read(window):
    return window.setup_s
