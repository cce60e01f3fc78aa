"""Roofline counts, one file a kernel: ``bound(run)``, the least seconds
one frame of its work can take on the card."""
