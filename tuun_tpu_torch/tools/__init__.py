"""Tools of the port: the local web runtime (web_demo)."""
