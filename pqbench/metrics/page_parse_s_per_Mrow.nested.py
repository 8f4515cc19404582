"""``page_parse_s_per_Mrow`` in ``orders_nested_scan``, per million orders:
the same reading.  Every lineitem leaf carries def and rep levels, which
the chunk walk declines, so this is the page loop's header walk and data
page parse and the dictionary-index, DELTA and byte-array walks; the level
streams' walks are ``level_walk_s_per_Mrow``'s."""

from pqbench.harness import reader_of

read = reader_of("page_parse_s_per_Mrow")
