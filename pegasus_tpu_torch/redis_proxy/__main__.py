from pegasus_tpu_torch.redis_proxy.proxy import main

main()
