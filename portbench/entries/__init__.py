"""One module per entry point the window drives, found by the `entry`
named in a traffic mix."""
