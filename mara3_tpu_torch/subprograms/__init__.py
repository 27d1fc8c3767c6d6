"""Runnable workloads (maps reference layer 9, src/subprog_*.cpp).

Each module registers itself with the app.subprogram registry on import,
the analog of the reference's make_subprog_* constructors collected in
app_main.cpp:41-47.
"""
