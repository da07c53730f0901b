"""Frame and flow I/O (numpy; imaging libraries load lazily)."""
