"""Serving: the micro-batching engine (scheduler.py) and its HTTP demo
server (app.py)."""
