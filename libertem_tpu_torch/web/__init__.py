"""The web GUI's server (counterpart of ``libertem_tpu/web/``): REST
and websocket API, job engine, shared state, notebook generator and
the single-page client; tornado is imported by ``server.py`` only."""
