"""The yardstick: the generator, the window, the trace reduction, the
roofline counts and peaks, and the comparison that decides `correct`."""
