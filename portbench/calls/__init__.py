"""Program side: one module per kind of call (a traffic mix's ``call``),
each driving one public entry of ``cfmm_routing_tpu_torch`` and reading its
answer into plain arrays for the judge.  The program is imported inside
the functions, never when this package is imported."""
