"""Run environment and metric logging of the port's CLIs."""
