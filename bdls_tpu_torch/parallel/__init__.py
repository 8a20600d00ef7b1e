"""The verify batch split across devices (K10), :mod:`.mesh`."""
